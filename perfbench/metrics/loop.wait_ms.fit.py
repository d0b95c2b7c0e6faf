"""Milliseconds the host loop waits for one round attempt, the program's
``loop.fetch`` span (the one host read of the round's scalars, which
waits for the device): per fit its total over its attempts, then the
median over the fits the process kept (`repro_torch.obs.recent_roots`).
None where the program keeps no spans."""
import statistics


def read(run):
    from repro_torch import obs
    recent = getattr(obs, "recent_roots", None)
    if recent is None:
        return None
    vals = []
    for r in recent("estimator.fit"):
        s, n = r.total("loop.fetch")
        if r.ok and n:
            vals.append(1e3 * s / n)
    return statistics.median(vals) if vals else None
