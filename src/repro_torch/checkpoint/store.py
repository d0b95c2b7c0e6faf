"""Atomic, checksummed, keep-N checkpoints in the JAX package's layout.

Port of `repro/checkpoint/store.py`. The on-disk format is the same byte
for byte, so a checkpoint written by either package restores in the
other:

    <dir>/step_000000042.v<token>/
        manifest.json     {step, time, leaves: {key -> {file, shape,
                           dtype, logical_dtype, crc}}}
        extra.json        optional JSON sidecar (loop metadata/manifest)
        arr_0000.npy ...  one file per leaf
    (unversioned ``step_000000042`` dirs from older writers stay
    readable; a versioned dir for the same step supersedes them.)

Leaves are keyed as JAX's ``keystr`` keys a pytree path, in JAX's
flattening order: dict keys sorted (``['a']``), dataclass and
`NamedTuple` fields in declaration order (``.C``, ``.mu``); a ``None`` is
an empty subtree and gets no file. `_flatten` is the port's own walk
over nested dicts, frozen dataclasses and NamedTuples (the optimizer's
`AdamWState`) of tensors, arrays or numbers, so a training checkpoint
``{"params", "opt"}`` has the JAX package's keys too.

Properties:
  * atomic: written to a ``.tmp-<pid>`` dir, then renamed to a FRESH
    versioned final name; the previous checkpoint of the same step is
    garbage-collected only after the new one is on disk, so a crashed
    writer never corrupts or loses the latest checkpoint;
  * checksummed: crc32 per leaf, verified on restore;
  * keep-N garbage collection (plus superseded same-step versions and
    crashed writers' tmp dirs older than ``_TMP_TTL_S``);
  * async: ``save(..., background=True)`` copies every leaf to host
    memory before it returns and writes the files on a thread, so a
    round that runs meanwhile can never change what is written.

bfloat16 leaves are bit-cast to uint16 with their ``logical_dtype``
recorded, as the JAX package stores them (numpy has no bfloat16);
`restore` casts them back.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
import time
import zlib
from pathlib import Path
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

# logical dtype -> (torch dtype, a same-width signed torch dtype, its
# numpy twin, the unsigned numpy container the file holds)
_EXOTIC = {
    "bfloat16": (torch.bfloat16, torch.int16, np.int16, np.uint16),
}


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree: Any, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs of ``tree`` in JAX's order, keyed as JAX's
    ``keystr`` keys them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{path}[{k!r}]")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _flatten(getattr(tree, name), f"{path}.{name}")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _flatten(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def _rebuild(tree: Any, leaf_fn, path: str = "") -> Any:
    """``tree`` with each leaf replaced by ``leaf_fn(key, leaf)``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, f"{path}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return tree._replace(**{
            name: _rebuild(getattr(tree, name), leaf_fn, f"{path}.{name}")
            for name in tree._fields})
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _rebuild(getattr(tree, f.name), leaf_fn,
                             f"{path}.{f.name}")
            for f in dataclasses.fields(tree)})
    return leaf_fn(path, tree)


def _snapshot(leaf: Any) -> Tuple[np.ndarray, str]:
    """(host array that owns its memory, logical dtype) of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        logical = str(t.dtype).removeprefix("torch.")
        if logical in _EXOTIC:
            _, signed, _, container = _EXOTIC[logical]
            t = t.view(signed)
        # .cpu() copies a device tensor; a CPU tensor's .numpy() shares
        # its memory, so copy that one
        arr = t.cpu().numpy() if t.device.type != "cpu" else t.numpy().copy()
        if logical in _EXOTIC:
            arr = arr.view(container)
        return arr, logical if logical in _EXOTIC else str(arr.dtype)
    arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _parse_step_dir(name: str) -> Optional[Tuple[int, int]]:
    """step_000000042[.v<token>] -> (step, version); None if not a
    (complete) checkpoint dir name. Unversioned legacy dirs sort as
    version -1 so any versioned rewrite supersedes them."""
    if ".tmp-" in name or not name.startswith("step_"):
        return None
    stem = name[len("step_"):]
    stem, _, ver = stem.partition(".v")
    try:
        return int(stem), (int(ver) if ver else -1)
    except ValueError:
        return None


# crashed-writer .tmp- dirs older than this are garbage-collected (a
# healthy writer renames its tmp away within one save)
_TMP_TTL_S = 300.0


class CheckpointStore:
    def __init__(self, directory, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ------------------------------------------------------------
    def save(self, step: int, tree: Any, *, background: bool = False,
             extra: Optional[Dict[str, Any]] = None) -> None:
        """Copy every leaf to host memory, then write. With
        ``background=True`` it returns after the copy and the files are
        written on a thread (`wait` joins it).

        ``extra``: optional JSON-safe dict written as ``extra.json``
        inside the step dir (read back with `read_extra`)."""
        host = [(k, *_snapshot(leaf)) for k, leaf in _flatten(tree)]
        if background:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host, extra: Optional[Dict[str, Any]]):
        # fresh versioned final name: the atomic rename lands NEXT TO any
        # previous version of this step instead of over it, so a crash at
        # any point leaves the previous checkpoint intact
        token = time.time_ns()
        final = self.dir / f"step_{step:09d}.v{token}"
        tmp = self.dir / f"{final.name}.tmp-{os.getpid()}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "time": time.time(), "leaves": {}}
        for i, (k, arr, logical) in enumerate(host):
            fn = f"arr_{i:04d}.npy"
            np.save(tmp / fn, arr)
            manifest["leaves"][k] = {
                "file": fn, "shape": list(arr.shape),
                "dtype": str(arr.dtype), "logical_dtype": logical,
                "crc": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        if extra is not None:
            (tmp / "extra.json").write_text(json.dumps(extra, indent=1))
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        os.rename(tmp, final)
        self._gc()

    def _step_dirs(self) -> Dict[int, Path]:
        """Newest complete dir per step (versioned beats legacy)."""
        best: Dict[int, Tuple[int, Path]] = {}
        for p in self.dir.glob("step_*"):
            parsed = _parse_step_dir(p.name)
            if parsed is None or not (p / "manifest.json").exists():
                continue
            step, ver = parsed
            if step not in best or ver > best[step][0]:
                best[step] = (ver, p)
        return {s: p for s, (v, p) in best.items()}

    def _gc(self) -> None:
        dirs = self._step_dirs()
        # superseded versions of surviving steps
        for p in self.dir.glob("step_*"):
            parsed = _parse_step_dir(p.name)
            if parsed is None:
                continue
            step, _ = parsed
            if dirs.get(step) is not None and p != dirs[step]:
                shutil.rmtree(p, ignore_errors=True)
        # keep-N on steps
        steps = sorted(dirs)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(dirs[s], ignore_errors=True)
        # crashed-writer tmp dirs: a failed rename leaves a fresh-named
        # .tmp- dir no later save will ever match; reap old ones here
        now = time.time()
        for p in self.dir.glob("*.tmp-*"):
            try:
                if now - p.stat().st_mtime > _TMP_TTL_S:
                    shutil.rmtree(p, ignore_errors=True)
            except OSError:
                pass

    def clear(self) -> None:
        """Remove every checkpoint (and tmp debris) in the directory."""
        self.wait()
        for p in self.dir.glob("step_*"):
            if _parse_step_dir(p.name) is not None or ".tmp-" in p.name:
                shutil.rmtree(p, ignore_errors=True)

    # -- restore ----------------------------------------------------------
    def steps(self):
        return sorted(self._step_dirs())

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def _dir_for(self, step: Optional[int]) -> Tuple[int, Path]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dirs().get(step)
        if d is None:
            raise FileNotFoundError(f"no checkpoint for step {step} in "
                                    f"{self.dir}")
        return step, d

    def read_extra(self, step: Optional[int] = None
                   ) -> Optional[Dict[str, Any]]:
        """The ``extra`` dict saved with the step (None if absent)."""
        _, d = self._dir_for(step)
        p = d / "extra.json"
        return json.loads(p.read_text()) if p.exists() else None

    def restore(self, tree_like: Any, *, step: Optional[int] = None,
                device=None, verify: bool = True) -> Any:
        """Restore into the structure of ``tree_like``: each leaf becomes
        a tensor on ``device`` (the CPU by default) with the dtype it was
        saved with."""
        step, d = self._dir_for(step)
        manifest = json.loads((d / "manifest.json").read_text())
        device = torch.device(device) if device is not None else None

        def load(key: str, _proto: Any) -> torch.Tensor:
            ent = manifest["leaves"].get(key)
            if ent is None:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = np.load(d / ent["file"])
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != ent["crc"]:
                    raise IOError(f"checksum mismatch for {key}")
            logical = ent.get("logical_dtype", ent["dtype"])
            if logical != str(arr.dtype) and logical in _EXOTIC:
                dtype, _, np_signed, _ = _EXOTIC[logical]
                t = torch.from_numpy(arr.view(np_signed).copy()).view(dtype)
            else:
                # np.load may hand back a read-only array: own a copy
                t = torch.from_numpy(arr.copy())
            return t.to(device) if device is not None else t

        return _rebuild(tree_like, load)
