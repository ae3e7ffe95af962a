"""``dcn_ms.eval``: device ms of the four DCN heads in an eager forward,
the kernels launched inside the program's ``mvster.dcn`` ranges
(``drivers/eval_dcn.py``)."""


def read(res):
    prof = res.get("dcn") or {}
    if not prof.get("heads_s"):
        return None
    return 1e3 * prof["heads_s"] / prof["iters"]
