"""Port completeness: every name in an ``__all__`` of the JAX package has a
counterpart in the port.

The walk reads source with ``ast`` and imports nothing of either package
(only the port's names map, ``elvis_tpu_torch/counterparts.py``). For each
module ``elvis_tpu/<path>.py`` and each name in its ``__all__``, one of:

  * ``elvis_tpu_torch/<path>.py`` defines or imports the name at module level;
  * ``COUNTERPARTS`` maps it (by the module that defines it, for a
    re-export) to port names that exist, or to the reason it is absorbed;
  * it is a re-export of an ``__init__`` and the port defines it somewhere.

A name the JAX package gains later fails here until the port has it.
"""

import ast
from pathlib import Path

from elvis_tpu_torch.counterparts import COUNTERPARTS

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "elvis_tpu", ROOT / "elvis_tpu_torch"


def _body_statements(body):
    """Module-level statements, with those under ``if`` / ``try`` / ``with``."""
    for node in body:
        if isinstance(node, ast.If):
            yield from _body_statements(node.body + node.orelse)
        elif isinstance(node, ast.Try):
            yield from _body_statements(node.body + node.orelse + node.finalbody
                                        + [s for h in node.handlers for s in h.body])
        elif isinstance(node, ast.With):
            yield from _body_statements(node.body)
        else:
            yield node


def _module(path):
    """``(names defined or imported at module level, __all__ or None,
    {imported name: source module relative to the package})``."""
    defined, exported, sources = set(), None, {}
    for node in _body_statements(ast.parse(path.read_text()).body):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            defined.add(node.name)
        elif isinstance(node, ast.Import):
            defined.update((a.asname or a.name).split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                defined.add(a.asname or a.name)
                if node.module and node.module.split(".")[0] in ("elvis_tpu", "elvis_tpu_torch"):
                    sources[a.asname or a.name] = node.module.split(".", 1)[-1]
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                defined.update(n.id for n in ast.walk(t) if isinstance(n, ast.Name))
            if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
                exported = list(ast.literal_eval(node.value))
    return defined, exported, sources


def _dotted(rel):
    """``kernels/block_transform.py`` -> ``kernels.block_transform``
    (an ``__init__`` is its package)."""
    parts = list(rel.with_suffix("").parts)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _port_modules():
    return {_dotted(p.relative_to(PORT)): _module(p)[0] for p in PORT.rglob("*.py")}


def _port_has(port, dotted_name):
    module, _, name = dotted_name.rpartition(".")
    return name in port.get(module, ())


def test_every_jax_public_name_has_a_counterpart_in_the_port():
    port = _port_modules()
    anywhere = set().union(*port.values())
    gaps, checked, modules = [], 0, 0
    for path in sorted(JAX.rglob("*.py")):
        _, exported, sources = _module(path)
        if not exported:
            continue
        modules += 1
        rel = path.relative_to(JAX)
        module = _dotted(rel)
        for name in exported:
            checked += 1
            if name in port.get(module, ()):
                continue
            key = f"{sources.get(name, module)}.{name}"
            mapped = COUNTERPARTS.get(key)
            if isinstance(mapped, str) and mapped:
                continue
            if isinstance(mapped, tuple) and mapped:
                missing = [n for n in mapped if not _port_has(port, n)]
                if not missing:
                    continue
                gaps.append(f"{module}.{name}: mapped to {missing}, which the port lacks")
                continue
            if rel.name == "__init__.py" and name in anywhere:
                continue
            gaps.append(f"elvis_tpu/{rel}: {name}")
    assert modules > 30 and checked > 300, (modules, checked)
    assert not gaps, "JAX public names with no counterpart in the port:\n" + "\n".join(gaps)


def test_the_names_map_holds_only_names_the_port_does_not_keep():
    """Each entry names a JAX public name with no namesake at the port's
    same module path, and maps it to port names or to a reason."""
    port = _port_modules()
    for key, mapped in COUNTERPARTS.items():
        module, _, name = key.rpartition(".")
        _, exported, _ = _module(JAX / (module.replace(".", "/") + ".py"))
        assert name in (exported or ()), key
        assert not _port_has(port, key), f"{key}: the port keeps the name, drop the entry"
        assert (isinstance(mapped, str) and mapped.startswith("absorbed: ")) or (
            isinstance(mapped, tuple) and mapped), key
