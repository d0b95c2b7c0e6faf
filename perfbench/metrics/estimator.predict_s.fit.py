"""Seconds of the fit cell's ``predict(X)``, the program's
``estimator.predict`` span (the pageable upload of X, kernel 1, the
labels back): the median over the predicts the process kept
(`repro_torch.obs.recent_roots`). None where the program keeps no spans."""
import statistics


def read(run):
    from repro_torch import obs
    recent = getattr(obs, "recent_roots", None)
    if recent is None:
        return None
    vals = [r.seconds for r in recent("estimator.predict") if r.ok]
    return statistics.median(vals) if vals else None
