"""``convnext_ms.eval``: device ms of the three ConvNeXt blocks in an eager
forward, the kernels launched inside the program's ``mvster.convnext``
ranges (``drivers/eval_convnext.py``)."""


def read(res):
    prof = res.get("convnext") or {}
    if not prof.get("stem_s"):
        return None
    return 1e3 * prof["stem_s"] / prof["iters"]
