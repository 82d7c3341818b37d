"""Plain float32 reference of E2FGVI-HQ for the CPU tests: the benchmark's
own, ``port_bench/reference/e2fgvi.py``, written from upstream's equations
(github.com/MCG-NKU/E2FGVI) in upstream's NCHW layout with plain ``torch``
and TF32 off, importing nothing of either package: SPyNet, the encoder, the
second-order propagation with the deformable conv as a per-tap bilinear
gather (``deform_conv``), the focal transformer with four literal rolls, an
unfold of the pooled tokens and an explicit softmax, the decoder, and
``test.py``'s loop (``ReferenceE2FGVI.inpaint``). One reference serves
both, so the cell's check and these tests hold the port to the same
equations."""

from port_bench.reference.e2fgvi import ReferenceE2FGVI, deform_conv, read_weights

__all__ = ["ReferenceE2FGVI", "deform_conv", "read_weights"]
