"""Seconds a fit spends on its validation evaluations, the program's
``eval_mse`` spans (each round's at the configured cadence and the final
one): the median over the fits the process kept
(`repro_torch.obs.recent_roots`). None where the program keeps no spans."""
import statistics


def read(run):
    from repro_torch import obs
    recent = getattr(obs, "recent_roots", None)
    if recent is None:
        return None
    vals = [r.total("eval_mse")[0] for r in recent("estimator.fit")
            if r.ok]
    return statistics.median(vals) if vals else None
