"""``convnext_share.eval``: the ConvNeXt blocks' share of an eager forward's
device time, in % (``drivers/eval_convnext.py``)."""


def read(res):
    prof = res.get("convnext") or {}
    if not prof.get("stem_s") or not prof.get("forward_s"):
        return None
    return 100.0 * prof["stem_s"] / prof["forward_s"]
