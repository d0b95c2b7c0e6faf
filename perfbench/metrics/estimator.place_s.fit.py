"""Seconds a fit spends placing its data, the program's ``engine.place``
span (the fingerprint of X, the shuffle ``X[perm]``, the uploads of X and
X_val): the median over the fits the process kept
(`repro_torch.obs.recent_roots`). None where the program keeps no spans."""
import statistics


def read(run):
    from repro_torch import obs
    recent = getattr(obs, "recent_roots", None)
    if recent is None:
        return None
    vals = [r.total("engine.place")[0] for r in recent("estimator.fit")
            if r.ok]
    return statistics.median(vals) if vals else None
