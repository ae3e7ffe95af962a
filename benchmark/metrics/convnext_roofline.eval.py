"""``convnext_roofline.eval``: the ConvNeXt blocks' bound a forward
(``counts/convnext.py``) over their device time a forward
(``convnext_ms.eval``), in %."""


def read(res):
    prof = res.get("convnext") or {}
    if not prof.get("stem_s"):
        return None
    return 100.0 * prof["bound_ms"] / (1e3 * prof["stem_s"] / prof["iters"])
