"""The port's sharded train step against the JAX package's on the CPU,
and its layouts against DTensor's, on 4 spawned gloo ranks.

* The hybrid (jamba-v0.1-52b), encdec (whisper-tiny) and vlm
  (internvl2-76b) families at --reduced size on a (2, 2) ("data",
  "model") mesh, one step of n_micro 2 from the same weights and batch in
  both packages, f32 and bf16 arms: JAX's sharded step on 4 forced host
  devices (tests/jax_sharding_oracle.py) against the port's
  (`train.step.make_train_step(..., mesh=...)`), at
  tests/torch_sharded_cells.py's tolerances. The reduced jamba's MoE
  layers run the expert-parallel dispatch with its per-shard capacity;
  whisper's 4 heads divide the model dim, so its encoder and decoder
  attention shard over heads. The dense, moe and ssm families and the
  context-parallel cell are in tests/test_torch_sharding.py.
* `sharding.placements` handed to DTensor lays out each spec of
  `PLACEMENT_CASES` as `sharding.shard_tree` cuts it, on (2, 2) and
  (2, 2, 1) ("pod", "data", "model") meshes, and DTensor's
  ``full_tensor`` and `sharding.gather_tree` both put it back.
"""
import numpy as np
import pytest

import torch_dist_worker as worker
import torch_sharded_cells as cells

CELLS = ["hybrid-f32", "hybrid-bf16", "encdec-f32", "encdec-bf16",
         "vlm-f32", "vlm-bf16"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return cells.run_cells(tmp_path_factory, CELLS, placements=True)


@pytest.mark.parametrize("cell", CELLS)
def test_sharded_step_matches_jax(runs, cell):
    cells.check_cell(cell, runs[0], runs[1])


@pytest.mark.parametrize("case", range(len(worker.PLACEMENT_CASES)))
def test_placements_lay_out_as_dtensor_does(runs, case):
    for rank in runs[2]:
        assert rank[f"placements:{case}"].tolist() == [True, True, True], (
            worker.PLACEMENT_CASES[case])


def test_every_rank_ends_with_the_same_loss(runs):
    """The loss is the global batch's mean on every rank."""
    for cell in CELLS:
        losses = {float(r[f"{cell}:loss"]) for r in runs[2]}
        assert len(losses) == 1, (cell, losses)
        assert np.isfinite(list(losses)[0])
