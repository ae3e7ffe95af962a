"""``dcn_roofline.eval``: the DCN heads' bound a forward
(``counts/dcn.py``) over their device time a forward (``dcn_ms.eval``),
in %."""


def read(res):
    prof = res.get("dcn") or {}
    if not prof.get("heads_s"):
        return None
    return 100.0 * prof["bound_ms"] / (1e3 * prof["heads_s"] / prof["iters"])
