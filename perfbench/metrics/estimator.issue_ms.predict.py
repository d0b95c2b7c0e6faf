"""Milliseconds a predict request spends on the host before it waits for
its labels: the program's ``estimator.predict`` span less its
``predict.labels`` span (the labels back, which waits for kernel 1), the
median over the requests the process kept
(`repro_torch.obs.recent_roots`). None where the program keeps no spans."""
import statistics


def read(run):
    from repro_torch import obs
    recent = getattr(obs, "recent_roots", None)
    if recent is None:
        return None
    vals = [1e3 * (r.seconds - r.total("predict.labels")[0])
            for r in recent("estimator.predict")
            if r.ok and r.total("predict.labels")[1]]
    return statistics.median(vals) if vals else None
