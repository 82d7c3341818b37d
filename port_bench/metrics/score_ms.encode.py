"""CUDA events around the scoring calls (complexity, saliency, fusion),
mean over the window's segments, in ms."""


def read(run):
    spans = run.spans.get("score_s")
    return 1e3 * sum(spans) / len(spans) if spans else None
