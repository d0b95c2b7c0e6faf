"""Milliseconds the host loop spends issuing one round attempt, the
program's ``loop.issue`` span (the engine's round call: the host's work
to queue the round, not the device's): per fit its total over its
attempts (overflow retries count), then the median over the fits the
process kept (`repro_torch.obs.recent_roots`). None where the program
keeps no spans."""
import statistics


def read(run):
    from repro_torch import obs
    recent = getattr(obs, "recent_roots", None)
    if recent is None:
        return None
    vals = []
    for r in recent("estimator.fit"):
        s, n = r.total("loop.issue")
        if r.ok and n:
            vals.append(1e3 * s / n)
    return statistics.median(vals) if vals else None
