"""Faults planted under the timed path, to show that ``correct`` comes out
false: the benchmark's own tests run them on the CPU, ``controls.py``
(``--fault``) on the card at a cell's own size. Each takes what a driver's
``fault`` hook hands it."""

from __future__ import annotations


def altered_answer(out):
    """The stage-4 depth altered by 5% where the forward produces it."""
    d = out["stage_depths"]
    return {**out, "depth": out["depth"] * 1.05, "stage_depths": [*d[:3], d[3] * 1.05]}


def scaled_confidence(out):
    """The photometric confidence halved where the forward produces it;
    the depths are left alone."""
    return {**out, "confidence": out["confidence"] * 0.5}


def unchanged_state(step):
    """A train step that leaves the parameters and Adam's state as they were."""
    step.optimizer.step = lambda *a, **k: None


def half_batch(step):
    """A train step on the first half of each batch, its loss the mean over it."""
    full = step._step

    def half(batch):
        def cut(x):
            return {k: cut(v) for k, v in x.items()} if isinstance(x, dict) \
                else x[: x.shape[0] // 2]
        return full(cut(batch))

    step._step = half


BY_NAME = {"altered_answer": altered_answer, "scaled_confidence": scaled_confidence,
           "unchanged_state": unchanged_state, "half_batch": half_batch}
