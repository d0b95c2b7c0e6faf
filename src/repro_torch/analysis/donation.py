"""In-place reuse check: a store-backed fit fills ONE device buffer.

Port of `repro/analysis/donation.py`'s purpose, not of its mechanism.
The JAX package proves that every donated jit of the engine data path
aliases its donated operand (``donate_argnums`` is a request XLA may
silently turn into a copy); its historical bug was a segment writer that
copied the WHOLE data buffer on every segment write, so the out-of-core
fill held two generations of the dataset on the device and its bounded
memory claim was false with no test failing. The port has no
``donate_argnums``: its store-backed `_LocalRun` allocates the (N, d)
buffer ``_Xd`` once and writes each segment into it with ``copy_``
(`_LocalRun._ensure_prefix`). So the check here is of in-place reuse,
on the same bug class:

  * statically, a scan of the port's engines (``api/engines/*.py``)
    flags any ``torch.cat`` of, or ``.clone()`` of, ``_Xd`` in a
    per-round method (`replicated_lint.PER_ROUND_METHODS`)
    (``copying-write``);
  * at runtime, a store-backed fit's ``_Xd.data_ptr()`` must be the same
    before and after every ``_ensure_prefix`` (``buffer-moved``), and on
    a card the buffer plus what each growth allocated above the memory
    held when it began (its peak less that) must stay below twice the
    buffer (``second-buffer``): a copy of the buffer would need a second
    one. The other tensors of the process (the fit's state, a caller's
    own) are held before the growth and do not count.

On the mesh engines each rank holds and fills its own piece of the rows
(`_MeshRun._ensure_prefix`), so each rank runs the check on its own
buffer: the port's form of the JAX auditor's per-device ``piece_update``
check. Every rank calls `check_inplace` with the same arguments and its
mesh.
"""
from __future__ import annotations

import ast
import inspect
import logging
import tempfile
from pathlib import Path
from typing import Iterable, List, Optional

import torch

from repro_torch.analysis.report import Violation, rel, repo_root
from repro_torch.analysis.replicated_lint import PER_ROUND_METHODS
from repro_torch.api.loop import run_loop

_log = logging.getLogger(__name__)

#: files whose per-round methods write the data buffer (scanned set)
SCAN_GLOBS = ("src/repro_torch/api/engines/*.py",)

#: the engine attribute that holds the placed rows
BUFFER_ATTR = "_Xd"

#: calls that build a new tensor from their tensor arguments
_COPYING_FUNCS = {"cat", "concat", "concatenate"}


# -- static scan -------------------------------------------------------------

def _mentions_buffer(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == BUFFER_ATTR
               for n in ast.walk(node))


def scan_file(path) -> List[Violation]:
    """Copying writes of the buffer in the per-round methods of every
    class in ``path``."""
    path = Path(path)
    source = path.read_text()
    tree = ast.parse(source, filename=str(path))
    out: List[Violation] = []
    for cls in (n for n in tree.body if isinstance(n, ast.ClassDef)):
        for fn in cls.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name in PER_ROUND_METHODS):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                copying = (
                    (isinstance(f, ast.Attribute) and f.attr == "clone"
                     and _mentions_buffer(f.value))
                    or (isinstance(f, ast.Attribute)
                        and f.attr in _COPYING_FUNCS
                        and isinstance(f.value, ast.Name)
                        and f.value.id == "torch"
                        and any(_mentions_buffer(a) for a in node.args)))
                if copying:
                    snippet = " ".join(
                        (ast.get_source_segment(source, node) or "").split())
                    out.append(Violation(
                        checker="donation", kind="copying-write",
                        file=rel(path), line=node.lineno,
                        qualname=f"{cls.name}.{fn.name}",
                        detail=(f"copies the whole data buffer: {snippet} "
                                f"— write segments in place (copy_)")))
    return out


def scan(paths: Optional[Iterable[Path]] = None) -> List[Violation]:
    if paths is None:
        root = repo_root()
        paths = [p for pattern in SCAN_GLOBS
                 for p in sorted(root.glob(pattern))]
    return [v for p in paths for v in scan_file(p)]


# -- runtime check -----------------------------------------------------------

def check_inplace(store=None, config=None, *, device="cuda",
                  engine_factory=None, mesh=None) -> List[Violation]:
    """Run a store-backed fit and check that every ``_ensure_prefix``
    writes the one buffer in place (on a mesh, this rank's buffer); logs
    the growths, the buffer's bytes and (on a card) the peak allocated
    over the growth.

    ``store``: a `ChunkStore` (or its path); by default a small one is
    written to a temporary directory from a seed. ``config``: an
    unresolved `FitConfig` (default: a small tb fit). ``device``: the
    card unless the caller asks for the CPU. ``engine_factory``
    overrides engine construction (the selftest injects a copying
    engine). ``mesh``: the `DeviceMesh` of a ``backend="mesh"`` config.
    """
    import numpy as np

    from repro_torch.api.config import FitConfig
    from repro_torch.api.engines import make_engine
    from repro_torch.data.store import ChunkStore, write_store

    with tempfile.TemporaryDirectory() as tmp:
        if store is None:
            rng = np.random.default_rng(0)
            write_store(Path(tmp) / "store",
                        rng.normal(size=(4096, 8)).astype(np.float32),
                        chunk_rows=512)
            store = Path(tmp) / "store"
        opened = not isinstance(store, ChunkStore)
        st = ChunkStore(store) if opened else store
        try:
            if config is None:
                config = FitConfig(k=8, b0=256, capacity_floor=32,
                                   max_rounds=40)
            config = config.resolve(st.n)
            engine = (engine_factory(config) if engine_factory is not None
                      else make_engine(config, mesh=mesh))
            run = engine.begin(st, config, device=device)
            return _watch_fit(run, config)
        finally:
            if opened:
                st.close()


def _watch_fit(run, config) -> List[Violation]:
    cuda = run._Xd.device.type == "cuda"
    buf_bytes = run._Xd.numel() * run._Xd.element_size()
    grow = run._ensure_prefix
    fn = type(run)._ensure_prefix
    site = (rel(inspect.getsourcefile(fn)), fn.__code__.co_firstlineno,
            f"{type(run).__name__}._ensure_prefix")
    seen = {"growths": 0, "peak": 0, "extra": 0, "moved": 0, "over": 0}

    def watched(b):
        if b <= run._filled:
            return grow(b)
        ptr = run._Xd.data_ptr()
        if cuda:
            torch.cuda.synchronize(run._Xd.device)
            torch.cuda.reset_peak_memory_stats(run._Xd.device)
            held = torch.cuda.memory_allocated(run._Xd.device)
        out = grow(b)
        seen["growths"] += 1
        if run._Xd.data_ptr() != ptr:
            seen["moved"] += 1
        if cuda:
            peak = torch.cuda.max_memory_allocated(run._Xd.device)
            seen["peak"] = max(seen["peak"], peak)
            seen["extra"] = max(seen["extra"], peak - held)
            if buf_bytes + peak - held >= 2 * buf_bytes:
                seen["over"] += 1
        return out

    run._ensure_prefix = watched
    try:
        run_loop(run, config)
    finally:
        del run._ensure_prefix      # break the cycle run -> watched -> run
    _log.info("in-place: %d growths of a %d-byte buffer, data pointer "
              "moved %d times; %s", seen["growths"], buf_bytes,
              seen["moved"],
              f"the buffer plus the most a growth allocated "
              f"{buf_bytes + seen['extra']} bytes "
              f"({(buf_bytes + seen['extra']) / buf_bytes:.3f}x the "
              f"buffer; peak allocated {seen['peak']} bytes, "
              f"{seen['peak'] / buf_bytes:.3f}x, the process's other "
              f"tensors included)" if cuda
              else "memory not measured (CPU)")
    out: List[Violation] = []
    if seen["moved"]:
        out.append(Violation(
            checker="donation", kind="buffer-moved", file=site[0],
            line=site[1], qualname=site[2],
            detail=(f"_Xd.data_ptr() changed in {seen['moved']} of "
                    f"{seen['growths']} growths: the segment write made a "
                    f"new buffer instead of filling the old one")))
    if seen["over"]:
        out.append(Violation(
            checker="donation", kind="second-buffer", file=site[0],
            line=site[1], qualname=site[2],
            detail=(f"{seen['over']} growths allocated >= the "
                    f"{buf_bytes}-byte buffer again (at most "
                    f"{seen['extra']} bytes): two generations of the data "
                    f"on the device")))
    return out


def run(device="cuda") -> List[Violation]:
    """The static scan of the port's engines plus the runtime check."""
    return scan() + check_inplace(device=device)


def selftest(device="cuda") -> List[Violation]:
    """Replant the copying segment write and assert both the scan (at
    the planted file:line) and the runtime check flag it."""
    from repro_torch.analysis import _selftest as fx
    return fx.donation_fixture_violations(scan_file, check_inplace, device)
