"""``dcn_share.eval``: the DCN heads' share of an eager forward's device
time, in % (``drivers/eval_dcn.py``)."""


def read(res):
    prof = res.get("dcn") or {}
    if not prof.get("heads_s") or not prof.get("forward_s"):
        return None
    return 100.0 * prof["heads_s"] / prof["forward_s"]
