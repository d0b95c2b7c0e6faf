"""The port's invariant checkers (`repro_torch.analysis`) on the CPU.

They must pass on the port's clean tree AND still flag every planted bug
class at its file:line. Where a checker's logic is the JAX package's
(the lint's derivation analysis, the allowlist, the retrace accounting),
both packages' checkers read the same inputs and must agree; where the
port's differs by design (hostsync's two layers, the in-place check that
replaces donation), the port's fixture replants the JAX package's bug
class. The CUDA layer of hostsync is held on the card in
tests/test_torch_gpu.py.
"""
import contextlib
import json
import logging
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax  # noqa: F401  (JAX stays on the CPU: JAX_PLATFORMS=cpu)
import numpy as np
import pytest
import torch

from repro.analysis import allowlist as jal
from repro.analysis import replicated_lint as jlint
from repro.analysis import retrace as jretrace
from repro_torch.analysis import allowlist as al
from repro_torch.analysis import (donation, hostsync, replicated_lint,
                                  retrace)
from repro_torch.analysis import _selftest as fx
from repro_torch.analysis.report import Violation, repo_root
from repro_torch.core import collectives

FIXTURE = repo_root() / "src/repro_torch/analysis/_selftest.py"


def _kinds(found):
    return sorted((v.kind, v.line) for v in found)


@contextlib.contextmanager
def _one_rank_group():
    """A one-rank gloo group in this process, destroyed after (a later
    test in the same worker expects none)."""
    import socket

    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- replicated-control-flow lint -------------------------------------------

class TestLint:
    def test_clean_tree_is_clean(self):
        assert replicated_lint.run() == []

    def test_lints_the_ports_loop_and_engines(self):
        files = [p.relative_to(repo_root()).as_posix()
                 for p, _ in replicated_lint.default_files()]
        assert files[0] == "src/repro_torch/api/loop.py"
        assert "src/repro_torch/api/engines/local.py" in files

    def test_planted_violations_flagged_with_location(self):
        found = replicated_lint.lint_file(FIXTURE, mode="engine")
        assert {v.kind for v in found} == {"branch", "host-coercion",
                                           "rng-draw"}
        at = {(v.kind, v.qualname, v.line) for v in found}
        line = fx.leaky_line("if float(torch.max(state.stats.p)) > 1e9:")
        assert ("branch", "LeakyRun.nested_step", line) in at
        assert ("host-coercion", "LeakyRun.nested_step", line) in at
        assert ("rng-draw", "LeakyRun.mb_step",
                fx.leaky_line("if np.random.random() < 2.0:")) in at
        assert ("host-coercion", "LeakyRun.eval_mse",
                fx.leaky_line("_ = state.stats.sse[0].item()")) in at
        # the JAX fixture's plants, found by the JAX lint, are the same
        jfound = jlint.lint_file(
            repo_root() / "src/repro/analysis/_selftest.py", mode="engine")
        assert sorted((v.kind, v.qualname) for v in found) == \
            sorted((v.kind, v.qualname) for v in jfound)

    #: loop-region sources read alike by both packages' lints
    LOOPS = {
        "raw_device_read": (
            "def run_loop(run, config):\n"
            "    for _ in range(config.max_rounds):\n"
            "        new_state, info = run.nested_step(run.state, 1, None)\n"
            "        if info.overflow:\n"
            "            break\n"),
        "sanctioned": (
            "def run_loop(run, config):\n"
            "    for _ in range(config.max_rounds):\n"
            "        new_state, info = run.nested_step(run.state, 1, None)\n"
            "        hinfo = fetch_round_info(info)\n"
            "        if hinfo.overflow:\n"
            "            break\n"
            "        flag = run.sync_flag(True)\n"
            "        if flag:\n"
            "            break\n"),
        "wall_clock": (
            "import time\n"
            "def run_loop(run, config):\n"
            "    t0 = time.perf_counter()\n"
            "    while True:\n"
            "        if time.perf_counter() - t0 > config.budget:\n"
            "            break\n"),
        "helper_reads_state": (
            "def run_loop(run, config):\n"
            "    def record(hinfo):\n"
            "        if float(run.state.stats.sse.sum()) > 0:\n"
            "            pass\n"
            "    for _ in range(3):\n"
            "        record(None)\n"),
    }

    @pytest.mark.parametrize("name", sorted(LOOPS))
    def test_loop_regions_read_as_jax_reads_them(self, tmp_path, name):
        src = tmp_path / "loop.py"
        src.write_text(self.LOOPS[name])
        mine = replicated_lint.lint_file(src, mode="loop")
        assert _kinds(mine) == _kinds(jlint.lint_file(src, mode="loop"))
        assert bool(mine) == (name != "sanctioned")

    def test_torch_policy(self, tmp_path):
        """torch is the device root (its topology calls are safe), and
        .cpu()/.numpy() are coercions beside .item()/.tolist()."""
        src = tmp_path / "eng.py"
        src.write_text(
            "import torch\n"
            "class Run:\n"
            "    def nested_step(self, state, b, capacity):\n"
            "        if torch.distributed.get_rank() == 0:\n"
            "            pass\n"
            "        if torch.any(state.points.a < 0):\n"
            "            pass\n"
            "        n = state.points.a.cpu()\n"
            "        m = state.stats.C.numpy()\n"
            "        if self._mb_idx is None:\n"
            "            pass\n"
            "        return self._Xd.shape[0]\n")
        found = replicated_lint.lint_file(src, mode="engine")
        assert _kinds(found) == [("branch", 6), ("host-coercion", 8),
                                 ("host-coercion", 9)]


class TestAllowlist:
    def test_entry_requires_reason(self, tmp_path):
        f = tmp_path / "allow.txt"
        f.write_text("a.py::f::branch::x\n")
        with pytest.raises(ValueError, match="reason"):
            al.load(f)

    def test_matching_is_narrow_as_in_jax(self):
        kw = dict(file="a.py", qualname="f", kind="branch",
                  substring="foo", reason="r", lineno=1)
        e, je = al.Entry(**kw), jal.Entry(**kw)
        for vkw in (dict(kind="branch", file="a.py"),
                    dict(kind="host-coercion", file="a.py"),
                    dict(kind="branch", file="b.py")):
            v = Violation(checker="lint", line=3, qualname="f",
                          detail="if foo > 1", **vkw)
            assert e.matches(v) == je.matches(v)
            assert e.matches(v) == (vkw == dict(kind="branch", file="a.py"))

    def test_stale_entries_become_violations(self, tmp_path):
        f = tmp_path / "allow.txt"
        f.write_text("gone.py::f::branch::*  # excuses nothing\n")
        out = replicated_lint.run(files=[], allowlist_path=f)
        assert [v.kind for v in out] == ["stale-allowlist"]
        assert out[0].line == 1

    def test_ports_allowlist_parses_and_every_entry_is_used(self):
        entries = al.load()
        assert entries and all(e.reason for e in entries)
        assert all(e.file.startswith("src/repro_torch/") for e in entries)
        raw = []
        for p, m in replicated_lint.default_files():
            raw.extend(replicated_lint.lint_file(p, m))
        kept, used = al.apply(raw, entries)
        assert kept == [] and len(used) == len(entries)


# -- retrace accounting -------------------------------------------------------

def _key(b, cap, **extra):
    statics = {"b": b, "capacity": cap, "rho": 1.9, "bounds": "hamerly2",
               **extra}
    return ("nested_round",
            tuple(sorted((k, repr(v)) for k, v in statics.items())))


SITE = dict(site_file="x.py", site_line=1, qualname="t")

#: (diff, invoked) cases, read alike by both packages' checkers
RETRACE_CASES = {
    "one_per_bucket": ({_key(64, None): 1, _key(128, 32): 1},
                       [(64, None), (128, 32), (128, 32)]),
    "warm_cache": ({}, [(64, None), (128, 32)]),
    "rho_keyed": ({_key(64, 32, rho=1.9): 1, _key(64, 32, rho=1.91): 1},
                  [(64, 32), (64, 32)]),
    "uninvoked": ({_key(256, None): 1}, [(64, None)]),
}


@pytest.mark.parametrize("name", sorted(RETRACE_CASES))
def test_trace_violations_as_in_jax(name):
    diff, invoked = RETRACE_CASES[name]
    mine = retrace.trace_violations(diff, invoked, "nested_round", **SITE)
    theirs = jretrace.trace_violations(diff, invoked, "nested_round", **SITE)
    assert [(v.kind, v.detail) for v in mine] == \
        [(v.kind, v.detail.replace("cache keyed by", "keyed by"))
         for v in theirs]
    want = {"one_per_bucket": [], "warm_cache": [], "rho_keyed": ["retrace"],
            "uninvoked": ["unexpected-trace"]}[name]
    assert [v.kind for v in mine] == want


def test_lattice_violations_as_in_jax():
    invoked = [(64, None), (128, 32), (128, 48), (96, None), (256, 256)]
    mine = retrace.lattice_violations(invoked, 64, 256, **SITE)
    theirs = jretrace.lattice_violations(invoked, 64, 256, **SITE)
    assert [(v.kind, v.detail) for v in mine] == \
        [(v.kind, v.detail) for v in theirs]
    assert len(mine) == 3


def test_retrace_selftest_flags_rho_key_and_non_pow2_capacity():
    found = retrace.selftest()
    assert {v.kind for v in found} == {"retrace", "off-lattice-bucket"}
    rho = [v for v in found if v.kind == "retrace"]
    assert rho[0].line == fx.leaky_line("for rho in (1.90, 1.91, 1.92)")
    assert "traced 3x" in rho[0].detail and "rho" in rho[0].detail
    assert all(v.file.endswith("analysis/_selftest.py") for v in found)


def test_local_fit_keys_only_its_pow2_buckets(caplog):
    # the audit empties the counters itself: a second audit of the same
    # fit, every key of which the first one saw, counts them all again
    for _ in range(2):
        stats = {}
        with caplog.at_level(logging.INFO, logger=retrace.__name__):
            assert retrace.audit_backend("local", device="cpu",
                                         stats=stats) == []
        m = re.search(r"over (\d+) distinct \(b, capacity\) buckets, "
                      r"(\d+) first-seen keys",
                      caplog.records[-1].getMessage())
        assert m and 1 < int(m[1]) == int(m[2])
        assert stats["keys"] == stats["buckets"] == int(m[1])
    # the sharded backends are audited too: a one-rank mesh fit keys the
    # local fit's buckets (b is a data rank's prefix)
    with _one_rank_group():
        mesh = {}
        assert retrace.audit_backend("mesh", device="cpu", stats=mesh) == []
    assert mesh["keys"] == mesh["buckets"] == stats["buckets"]
    assert mesh["invoked"] == stats["invoked"]


def test_round_key_carries_width_type_and_device():
    from repro_torch.core.rounds import nested_round
    from repro_torch.core.state import init_state
    from repro_torch.util import tracecount
    tracecount.reset()
    for d in (4, 6):
        X = torch.from_numpy(
            np.random.default_rng(d).normal(size=(64, d)).astype(np.float32))
        nested_round(X, init_state(X, 4), b=32, rho=1.9, bounds="hamerly2",
                     capacity=16, plan=None)
    keys = [dict(statics) for (_, statics) in tracecount.snapshot()]
    assert sorted(k["d"] for k in keys) == ["4", "6"]
    assert {(k["k"], k["dtype"], k["device"]) for k in keys} == {
        ("4", "torch.float32", "device(type='cpu')")}


def test_retrace_audit_flags_a_round_the_hook_does_not_see(monkeypatch):
    from repro_torch.core import rounds
    monkeypatch.setattr(rounds.tracecount, "record",
                        lambda site, **statics: None)
    found = retrace.audit_backend("local", device="cpu")
    assert found and {v.kind for v in found} == {"missing-trace"}
    assert all(v.file == "src/repro_torch/core/rounds.py" for v in found)


# -- in-place reuse (the port's donation check) -------------------------------

class TestInPlace:
    def test_engines_scan_clean_and_fit_fills_one_buffer(self, caplog):
        assert donation.scan() == []
        with caplog.at_level(logging.INFO, logger=donation.__name__):
            assert donation.check_inplace(device="cpu") == []
        assert "data pointer moved 0 times" in caplog.records[-1].getMessage()

    def test_selftest_flags_the_copying_write(self):
        found = donation.selftest(device="cpu")
        line = fx.leaky_line("Xd = self._Xd.clone()")
        assert ("copying-write", line) in _kinds(found)
        moved = [v for v in found if v.kind == "buffer-moved"]
        assert moved and moved[0].qualname == "CopyingRun._ensure_prefix"

    def test_scan_flags_torch_cat_of_the_buffer(self, tmp_path):
        src = tmp_path / "eng.py"
        src.write_text(
            "import torch\n"
            "class Run:\n"
            "    def _ensure_prefix(self, b):\n"
            "        self._Xd = torch.cat([self._Xd[:b], self._Xd[b:]])\n"
            "    def restore(self, store, step, meta):\n"
            "        self._Xd = self._Xd.clone()\n")
        assert _kinds(donation.scan_file(src)) == [("copying-write", 4)]


# -- host-sync audit ----------------------------------------------------------

def _spied_scopes(make, loop, config_cls, **begin_kw):
    calls = {"round": 0, "sanctioned": []}

    class Spy:
        def round_scope(self):
            calls["round"] += 1
            return contextlib.nullcontext()

        def sanctioned_scope(self, what):
            calls["sanctioned"].append(what)
            return contextlib.nullcontext()

    rng = np.random.default_rng(0)
    X = rng.normal(size=(512, 4)).astype(np.float32)
    config = config_cls(k=4, b0=64, seed=0, max_rounds=8,
                        eval_every=2).resolve(512)
    run = make(config).begin(X, config, X_val=X[:64], **begin_kw)
    out = loop(run, config, audit=Spy())
    return calls, out


def test_loop_drives_the_audit_seam_as_jax_does():
    from repro.api.config import FitConfig as JConfig
    from repro.api.engines import make_engine as jmake
    from repro.api.loop import run_loop as jloop
    from repro_torch.api.config import FitConfig
    from repro_torch.api.engines import make_engine
    from repro_torch.api.loop import run_loop
    mine, out = _spied_scopes(make_engine, run_loop, FitConfig,
                              device="cpu")
    theirs, _ = _spied_scopes(jmake, jloop, JConfig)
    assert mine == theirs
    n_rounds = sum(1 for t in out.telemetry if t.batch_mse is not None)
    assert mine["round"] == n_rounds
    assert mine["sanctioned"].count("round_info") >= n_rounds
    assert "eval_mse" in mine["sanctioned"]


@pytest.mark.parametrize("traced", [False, True])
def test_clean_local_fit_has_no_unsanctioned_syncs(tmp_path, traced):
    from repro_torch.obs import read_events, summarize
    td = str(tmp_path / "tr") if traced else None
    assert hostsync.audit_backend("local", device="cpu", trace_dir=td) == []
    if traced:
        assert summarize(read_events(td))["rounds"] > 0


def test_store_and_mb_uploads_are_sanctioned(tmp_path):
    """The engine's mid-fit uploads (store segments, mb's permutation)
    run inside sanctioned_scope("upload")."""
    from repro_torch.api.config import FitConfig
    from repro_torch.api.engines import make_engine
    from repro_torch.api.loop import run_loop
    from repro_torch.data.store import ChunkStore, write_store
    X = np.random.default_rng(0).normal(size=(1024, 4)).astype(np.float32)
    write_store(tmp_path / "st", X, chunk_rows=128)
    seen = []

    class Spy(hostsync.HostSyncAudit):
        def sanctioned_scope(self, what):
            seen.append((what, self._in_round > 0))
            return super().sanctioned_scope(what)

    for data, algorithm in ((ChunkStore(tmp_path / "st"), "tb"),
                            (X, "mb")):
        config = FitConfig(k=4, b0=64, max_rounds=12, capacity_floor=32,
                           algorithm=algorithm).resolve(1024)
        run = make_engine(config).begin(data, config, device="cpu")
        audit = Spy(device="cpu")
        with audit.installed():
            run_loop(run, config, audit=audit)
        assert audit.violations == []
    assert ("upload", True) in seen
    assert sum(1 for w, _ in seen if w == "upload") >= 2


def test_hostsync_selftest_catches_the_planted_leak():
    found = hostsync.selftest(device="cpu")
    line = fx.leaky_line("if float(torch.max(state.stats.p)) > 1e9:")
    assert found and all(v.line == line for v in found)
    assert all(v.file.endswith("analysis/_selftest.py") for v in found)
    assert any(v.kind == "d2h-float" for v in found)
    assert all(v.qualname == "nested_step" for v in found)


def test_interceptor_restores_torch_tensor():
    x = torch.ones(())
    own = {n: torch.Tensor.__dict__.get(n) for n in hostsync._HOOKS}
    audit = hostsync.HostSyncAudit(device="cpu")
    with audit.installed():
        assert torch.Tensor.__dict__.get("__float__") is not None
        assert float(x) == 1.0           # outside a round: passes through
        with audit.round_scope():
            assert x.cpu() is x           # cpu of a CPU tensor: no sync
            assert x.item() == 1.0        # flagged
            with audit.sanctioned_scope("round_info"):
                assert x.tolist() == 1.0  # sanctioned
    assert {n: torch.Tensor.__dict__.get(n) for n in hostsync._HOOKS} == own
    assert [v.kind for v in audit.violations] == ["d2h-item"]
    assert audit.violations[0].file == "tests/test_torch_analysis.py"
    # the staging hook is the audit's while it is installed, and only then
    assert collectives.STAGING_HOOKS == []
    # the sharded backends are audited too: a one-rank xl fit, whose
    # collectives are the identity, stages nothing through the host
    with _one_rank_group():
        stats = {}
        assert hostsync.audit_backend("xl", device="cpu", stats=stats) == []
    assert stats == {"rounds": 24, "staged": 0, "staged_syncs": 0}


# -- CLI ----------------------------------------------------------------------

def _cli(*args):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=repo_root(), timeout=300,
        env={"PYTHONPATH": str(repo_root() / "src"),
             "PATH": "/usr/bin:/bin:/usr/local/bin"})


def test_cli_all_selftest_exits_zero_on_the_cpu():
    r = _cli("all", "--selftest", "--device", "cpu", "--ranks", "2")
    assert r.returncode == 0, r.stdout + r.stderr
    for check in ("lint", "hostsync", "retrace", "donation"):
        assert f"[{check}] selftest: planted bug class flagged" in r.stdout
    assert "device=cpu" in r.stdout and "_selftest.py" in r.stdout
    # and inside each of the 2 spawned ranks of the sharded backends
    for check in ("hostsync", "retrace"):
        m = re.search(rf"{check} selftest by rank: findings \[(.*)\]",
                      r.stdout)
        assert m and len(m[1].split(",")) == 2 and "0" not in m[1].split(
            ", "), r.stdout


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host "
                    "without a CUDA device")
def test_cli_runtime_auditors_refuse_to_leave_the_card_unasked():
    for args in (("all",), ("hostsync",), ("donation", "--selftest")):
        r = _cli(*args)
        assert r.returncode == 2, r.stdout + r.stderr
        assert "no CUDA device" in r.stderr and "--device cpu" in r.stderr
        assert "OK" not in r.stdout and "selftest:" not in r.stdout
    r = _cli("lint")                   # the AST lint needs no device
    assert r.returncode == 0 and "[lint] OK" in r.stdout


def test_cli_all_is_clean_and_refuses_unported_backends(tmp_path):
    r = _cli("all", "--device", "cpu", "--ranks", "2", "--trace-dir",
             str(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    for check in ("lint", "hostsync", "retrace", "donation"):
        assert f"[{check}] OK" in r.stdout
    assert "distinct (b, capacity) buckets" in r.stdout
    assert (tmp_path / "local" / "metrics-p00000.json").exists()
    # the default backends are JAX's (local, mesh, xl), the sharded ones
    # audited in 2 spawned gloo ranks (4 in the `sharded` fixture), each
    # writing its own trace stream
    assert ("[hostsync] OK (backends: local, mesh, xl; ranks 2; device "
            "cpu)") in r.stdout
    assert "retrace[xl] by rank: round calls [40, 40]" in r.stdout
    for r_ in range(2):
        assert (tmp_path / "mesh" / f"metrics-p{r_:05d}.json").exists()
    r = _cli("hostsync", "--backends", "local,mesh,sideways")
    assert r.returncode == 2 and "unknown backends ['sideways']" in r.stderr


# -- the sharded backends, one rank per process ------------------------------

TESTS = repo_root() / "tests"
SHARDED = {2: ("mesh", "xl", "multihost"), 4: ("mesh", "xl")}
CASES = [(n, b) for n, bs in SHARDED.items() for b in bs]


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """hostsync and retrace on every backend of `SHARDED` in 2 and in 4
    spawned gloo ranks (the 2-rank hostsync audits traced), beside JAX's
    retrace audit of the same backends on as many forced host devices
    (tests/jax_audit_oracle.py, in subprocesses started first)."""
    from repro_torch.analysis.ranks import RANK_CHECKS, spawn_audits
    wd = tmp_path_factory.mktemp("sharded")
    env = {"PYTHONPATH": f"{repo_root() / 'src'}:{TESTS}",
           "JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin:/usr/local/bin"}
    procs = [subprocess.Popen(
        [sys.executable, str(TESTS / "jax_audit_oracle.py"), str(wd),
         str(n), ",".join(bs)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for n, bs in SHARDED.items()]
    try:
        # the 2- and 4-rank groups run side by side
        with ThreadPoolExecutor(len(SHARDED)) as pool:
            futs = {n: pool.submit(
                spawn_audits, RANK_CHECKS, bs, ranks=n, device="cpu",
                trace_dir=str(wd / "tr") if n == 2 else None, timeout_s=240)
                for n, bs in SHARDED.items()}
        ranks = {n: f.result() for n, f in futs.items()}
        for p in procs:
            out, _ = p.communicate(timeout=300)
            assert p.returncode == 0, out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    jax_ = {n: json.loads((wd / f"jax_audit_{n}.json").read_text())
            for n in SHARDED}
    return ranks, jax_, wd / "tr"


@pytest.mark.parametrize("n,backend", CASES)
def test_sharded_audits_are_clean_in_every_rank(sharded, n, backend):
    """0 violations of either check in every rank; from empty counters
    every rank keys each invoked bucket once; on the CPU no collective
    stages a CUDA tensor."""
    ranks, _, _ = sharded
    assert len(ranks[n]) == n
    for res in ranks[n]:
        found, stats = res["hostsync"][backend]
        assert found == []
        assert stats == {"rounds": 24, "staged": 0, "staged_syncs": 0}
        found, stats = res["retrace"][backend]
        assert found == []
        assert stats["calls"] == 40 and stats["keys"] == stats["buckets"]
        assert stats["invoked"] == ranks[n][0]["retrace"][backend][1][
            "invoked"]


@pytest.mark.parametrize("n,backend", CASES)
def test_sharded_buckets_equal_jax_on_as_many_devices(sharded, n, backend):
    """The (b, capacity) buckets a rank's fit invokes are those of JAX's
    audit on n forced host devices (b is a data shard's prefix in both),
    and JAX's audit is clean too."""
    ranks, jax_, _ = sharded
    want = jax_[n][backend]
    assert want["violations"] == 0
    got = ranks[n][0]["retrace"][backend][1]["invoked"]
    assert [list(t) for t in got] == want["invoked"]


def test_two_rank_traced_audit_counts_rounds_once(sharded):
    """Each rank writes its own stream; `summarize` counts the fit's
    rounds once, from the lead rank, and lists both ranks."""
    from repro_torch.obs import read_events, summarize
    _, _, tr = sharded
    for backend in SHARDED[2]:
        s = summarize(read_events(tr / backend))
        assert s["rounds"] == 24, backend
        assert s["processes"] == [0, 1]
        assert s["rounds_by_process"] == {0: 24, 1: 24}


def test_gloo_staging_scope_sanctions_only_its_syncs():
    """`core.collectives` opens the audit's staging scope around a gloo
    collective of a CUDA tensor only; inside it a sync-debug sync is
    counted, not a violation, while a host coercion still is one."""
    import types
    cuda_like = types.SimpleNamespace(is_cuda=True)
    cpu = torch.ones(2)
    audit = hostsync.HostSyncAudit(device="cpu")
    with _one_rank_group(), audit.installed():
        with audit.round_scope():
            with collectives._staged(cpu, None):
                assert audit.staged == 0
            with collectives._staged(cuda_like, None):
                audit.notify("cuda-sync")
                audit.notify("item")
            audit.notify("cuda-sync")
    assert (audit.rounds, audit.staged, audit.staged_syncs) == (1, 1, 1)
    assert sorted(v.kind for v in audit.violations) == ["cuda-sync",
                                                        "d2h-item"]
    with collectives._staged(cuda_like, None):   # no audit: no scope
        pass
    assert collectives.STAGING_HOOKS == []
    # on a card the scope counts the sync warnings gloo's own thread has
    # c10 write to fd 2, and passes every other line through
    import os
    with hostsync._stderr_syncs() as n:
        os.write(2, f"[W] {hostsync._SYNC_WARNING} (function f)\n".encode())
    assert n == [1]
