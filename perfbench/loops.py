"""The general traffic generator: one closed loop for each kind of call
the program serves, parameterised by a traffic file.

A traffic file (``perfbench/traffic/<name>.json``) names its ``kind`` and
gives the parameters of that kind; a configuration file gives the sizes.
A loop makes the inputs from the seed (`datagen`), builds what the
program needs for them, warms up every shape the window will use with one
unit, then runs one unit a call:

* ``fit``: ``NestedKMeans(FitConfig(...)).fit(X, X_val=X_val)`` then
  ``.predict(X)``, on host arrays, as a user hands them. The units take
  the fixed fit seeds ``shuffle_seeds`` in turn, in an order drawn from
  the run's seed, and a window ends with a whole turn: a fit's rounds
  depend on its shuffle (190 to 420 on infMNIST), so every window holds
  the same set of fits, each as often.
* ``dp_round``: the data-parallel round ``make_dp_round(None, fused=)``
  over the resident rows, its centroids carried from round to round from
  the first k rows; each round ends in a host read of its batch MSE, as
  a loop that decides on it does.
* ``predict``: ``NestedKMeans.predict`` on the next slice of the
  resident rows (a device tensor), the labels back on the host, by an
  estimator that adopted a codebook made from the seed.

Each loop keeps the answers of its window (on the host, or the few it
judges on the card) and judges a sample of them, drawn from the seed,
against the configuration's reference once the window has closed.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import datagen


def _fit_config(config: dict, seed: int):
    from repro_torch.api import FitConfig
    rho = config["rho"]
    return FitConfig(k=config["k"], algorithm=config["algorithm"],
                     rho=math.inf if rho == "inf" else float(rho),
                     b0=config["b0"], bounds=config["bounds"],
                     seed=int(seed) % (1 << 63))


def _free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def _inputs_made(device) -> int:
    """The device allocator's peak so far (the inputs' making), after
    which its peak is reset: the window's peak is then the program's."""
    if torch.device(device).type != "cuda":
        return 0
    _free(device)
    peak = int(torch.cuda.max_memory_allocated(device))
    torch.cuda.reset_peak_memory_stats(device)
    return peak


class Loop:
    """One cell's closed loop. ``keep`` is True while the window runs:
    only the window's answers are judged."""

    #: units of the traced run's instrumented and profiled passes
    instrumented_units = 1
    profiled_units = 1
    #: a window holds a whole number of turns of this many units
    cycle = 1
    #: the allocator's peak while the inputs were made (`_inputs_made`)
    inputs_peak_bytes = 0

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference):
        self.config = config
        self.traffic = traffic
        self.seed = int(seed)
        self.device = torch.device(device)
        self.ref = reference
        self.keep = False
        self.answers: List[dict] = []

    def sample(self, count: int) -> List[dict]:
        """Up to ``count`` of the window's answers, drawn from the seed."""
        rng = random.Random(self.seed)
        picked = sorted(rng.sample(range(len(self.answers)),
                                   min(count, len(self.answers))))
        return [self.answers[i] for i in picked]

    def setup(self) -> None:
        raise NotImplementedError

    def unit(self) -> dict:
        raise NotImplementedError

    def release(self) -> None:
        """Frees the program's state; the inputs and answers stay."""

    def judge(self) -> List[Dict[str, float]]:
        raise NotImplementedError

    def control(self) -> List[Dict[str, float]]:
        """The reference at the precision below the configuration's, put
        in the program's place and judged as the program is."""
        raise NotImplementedError


class FitLoop(Loop):
    instrumented_units = 1
    profiled_units = 1

    def setup(self) -> None:
        data = datagen.make(self.config, self.seed, self.device)
        self.X = data["X"].cpu().numpy()
        self.X_val = data["X_val"].cpu().numpy()
        del data
        self.inputs_peak_bytes = _inputs_made(self.device)
        self.fit_config = _fit_config(self.config, self.seed)
        seeds = list(self.traffic["shuffle_seeds"])
        self.order = random.Random(self.seed).sample(seeds, len(seeds))
        self.cycle = len(seeds)
        self.index = 0
        self.unit()
        self.index = 0

    def _fit(self, cfg) -> tuple:
        from repro_torch.api import NestedKMeans
        t0 = time.perf_counter()
        km = NestedKMeans(cfg, device=self.device).fit(
            self.X, X_val=self.X_val)
        predicted = km.predict(self.X)      # on the host: waits
        wall = time.perf_counter() - t0
        rounds = [r for r in km.telemetry_ if r.batch_mse is not None]
        rec = {"wall_s": wall, "rounds_s": km.telemetry_[-1].t,
               "rounds": len(rounds),
               "sum_b": sum(r.b for r in rounds),
               "sum_recomputed": sum(r.n_recomputed for r in rounds),
               "k_scan_rows": sum(r.b for r in rounds) + len(self.X),
               "converged": bool(km.converged_)}
        answer = {"C": km.cluster_centers_, "labels": km.labels_,
                  "predicted": predicted, "val_mse": km.final_mse_}
        return rec, answer

    def _config(self):
        return dataclasses.replace(
            self.fit_config, seed=self.order[self.index % self.cycle])

    def unit(self) -> dict:
        rec, answer = self._fit(self._config())
        self.index += 1
        if self.keep:
            self.answers.append(answer)
        return rec

    def _judge(self, answers) -> List[Dict[str, float]]:
        X = torch.from_numpy(self.X).to(self.device)
        X_val = torch.from_numpy(self.X_val).to(self.device)
        out = []
        for ans in answers:
            on = {k: (torch.from_numpy(np.asarray(v)).to(self.device)
                      if k != "val_mse" else float(v))
                  for k, v in ans.items()}
            out.append(self.ref.judge_fit(X, X_val, on))
        return out

    def judge(self) -> List[Dict[str, float]]:
        return self._judge(self.sample(self.traffic["judged"]))

    def control(self) -> List[Dict[str, float]]:
        """The fit has no plain reference of its own that could stand in
        its place: the program's own plain path (``kernel_backend="ref"``)
        with the card's TF32 switch on serves as the control."""
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            cfg = dataclasses.replace(self._config(), kernel_backend="ref")
            _, answer = self._fit(cfg)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
        return self._judge([answer])


class DpRoundLoop(Loop):
    instrumented_units = 3
    profiled_units = 3

    def setup(self) -> None:
        from repro_torch.core.distributed import make_dp_round
        data = datagen.make(self.config, self.seed, self.device)
        self.X = data["X"]
        del data
        self.C0 = self.X[:self.config["k"]].clone()
        self.inputs_peak_bytes = _inputs_made(self.device)
        self.step = make_dp_round(None, fused=self.traffic["fused"])
        # the round judged besides the first and the last
        self.pick = random.Random(self.seed).randrange(
            1, self.traffic["judged_round_below"])
        self.kept: Dict[int, dict] = {}
        self.C = self.C0
        self.unit()
        self.C, self.index = self.C0, 0

    def unit(self) -> dict:
        t0 = time.perf_counter()
        C_new, S, v, a, d, _, _, mse = self.step(self.X, self.C)
        float(mse)                          # the host reads the round
        wall = time.perf_counter() - t0
        if self.keep:
            out = {"C_in": self.C, "a": a, "d": d, "S": S, "v": v,
                   "C": C_new}
            if self.index in (0, self.pick):
                self.kept[self.index] = out
            self.last = out
            self.index += 1
        self.C = C_new
        return {"wall_s": wall, "k_scan_rows": self.X.shape[0]}

    def release(self) -> None:
        self.keep = False
        if hasattr(self, "last"):
            self.kept[self.index - 1] = self.last
            del self.last
        self.answers = [self.kept[i] for i in sorted(self.kept)]
        self.C = None
        _free(self.device)

    def judge(self) -> List[Dict[str, float]]:
        return [self.ref.judge_round(self.X, ans["C_in"], ans)
                for ans in self.answers]

    def control(self) -> List[Dict[str, float]]:
        out, C = [], self.C0
        for _ in range(2):
            got = self.ref.dp_round(self.X, C, "tf32")
            out.append(self.ref.judge_round(self.X, C, got))
            C = got["C"]
        return out


class PredictLoop(Loop):
    instrumented_units = 10
    profiled_units = 10

    def setup(self) -> None:
        from repro_torch.api import NestedKMeans
        from repro_torch.api.loop import FitOutcome
        from repro_torch.convert import codebook_from_numpy
        from repro_torch.core.state import KMeansState, PointState
        data = datagen.make(self.config, self.seed, self.device)
        self.X, self.codebook = data["X"], data["codebook"]
        del data
        self.inputs_peak_bytes = _inputs_made(self.device)
        rows = self.traffic["rows_per_request"]
        self.rows = min(rows, self.X.shape[0])
        self.slices = self.X.shape[0] // self.rows
        cfg = _fit_config(self.config, self.seed)
        C = self.codebook.cpu().numpy()
        stats = codebook_from_numpy(C, np.ones(len(C), np.float32),
                                    device=self.device)
        empty = torch.zeros(0, device=self.device)
        state = KMeansState(
            stats=stats, points=PointState(
                a=empty.to(torch.int32), d=empty, lb=empty),
            elkan=None, round=torch.zeros((), dtype=torch.int32,
                                          device=self.device))
        outcome = FitOutcome(C=C, state=state,
                             labels=np.zeros(0, np.int32), telemetry=[],
                             converged=True, algorithm=cfg.algorithm,
                             config=cfg)
        self.km = NestedKMeans(cfg, device=self.device).adopt(outcome)
        self.index = 0
        self.unit()
        self.index = 0

    def unit(self) -> dict:
        q = self.index % self.slices
        x = self.X[q * self.rows:(q + 1) * self.rows]
        t0 = time.perf_counter()
        labels = self.km.predict(x)         # on the host: waits
        wall = time.perf_counter() - t0
        if self.keep:
            self.answers.append({"slice": q, "labels": labels})
        self.index += 1
        return {"wall_s": wall, "k_scan_rows": self.rows}

    def release(self) -> None:
        self.km = None
        _free(self.device)

    def judge(self) -> List[Dict[str, float]]:
        out = []
        for ans in self.sample(self.traffic["judged"]):
            q = ans["slice"]
            x = self.X[q * self.rows:(q + 1) * self.rows]
            labels = torch.from_numpy(ans["labels"]).to(self.device)
            out.append(self.ref.judge_labels(x, self.codebook, labels))
        return out

    def control(self) -> List[Dict[str, float]]:
        out = []
        for q in range(min(2, self.slices)):
            x = self.X[q * self.rows:(q + 1) * self.rows]
            labels = self.ref.assign(x, self.codebook, "tf32")[0]
            out.append(self.ref.judge_labels(x, self.codebook, labels))
        return out


#: a traffic file's ``kind`` -> its loop
LOOPS = {"fit": FitLoop, "dp_round": DpRoundLoop,
           "predict": PredictLoop}
