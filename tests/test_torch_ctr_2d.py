"""The port's CTR families on the 2-D table plane against the JAX package's, on the CPU.

``packed: 0`` for each family, and FFM whose table dim is above a 128-lane
tile (``1 + num_fields * factor_dim``), which takes the 2-D plane whatever
``packed`` says, in both packages. Both trainers get the same config and
data; the JAX trainer's start state (the ``[C, dim]`` table, its AdaGrad
``accum`` slot, the dense dict and its optax accumulators) is carried into
the port with ``convert.ctr_state_from_numpy``, and both take 3 steps on
the same batches, the JAX one through ``jax.jit(train_step)``. Each step's
loss agrees within ``LOSS_RTOL``; each array's change from the start agrees
with JAX's elementwise within ``DELTA_RTOL`` of its largest change (the
field sums, the MLP's products and the order of the duplicate adds differ;
XLA contracts AdaGrad's multiply-adds). The 2-D plane's AdaGrad is the
per-sample accumulator; ``tests/test_torch_store_2d.py`` pins it alone.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from swiftsnails_tpu.models.registry import get_model as jax_get_model
from swiftsnails_tpu.utils.config import Config as JaxConfig
from swiftsnails_tpu_torch import convert
from swiftsnails_tpu_torch.data import ctr
from swiftsnails_tpu_torch.framework.checkpoint import export_table_text
from swiftsnails_tpu_torch.framework.trainer import TrainLoop
from swiftsnails_tpu_torch.models.registry import get_model
from swiftsnails_tpu_torch.ops import rowdma
from swiftsnails_tpu_torch.utils.config import Config

LOSS_RTOL = 1e-5
DELTA_RTOL = 1e-4
STEPS = 3
torch.set_num_threads(1)

# case -> (model, fields, config keys)
CASES = {
    "logreg_sgd": ("logreg", 6, {"optimizer": "sgd", "packed": 0}),
    "logreg_adagrad": ("logreg", 6, {"packed": 0}),
    "fm": ("fm", 6, {"factor_dim": 4, "packed": 0}),
    "ffm": ("ffm", 6, {"factor_dim": 4, "packed": 0}),
    "widedeep": ("widedeep", 6, {"embed_dim": 8, "hidden_dims": "32,16", "packed": 0}),
    # 1 + 13 * 10 = 131 > 128: the 2-D plane with packed left at its default
    "ffm_wide": ("ffm", 13, {"factor_dim": 10}),
    "ffm_wide_sgd": ("ffm", 13, {"factor_dim": 10, "optimizer": "sgd"}),
}


def _conf(fields, **over):
    conf = {"num_fields": str(fields), "capacity": str(1 << 11), "learning_rate": "0.2",
            "optimizer": "adagrad", "batch_size": "256", "num_iters": "1", "seed": "0"}
    conf.update({k: str(v) for k, v in over.items()})
    return conf


def _data(fields):
    labels, feats, _ = ctr.synth_ctr(1024, fields, 40, seed=4)
    feats[::5, 2] = ctr.PAD
    feats[::9, 4:] = ctr.PAD
    return labels, feats


def _pair(case):
    name, fields, over = CASES[case]
    conf, data = _conf(fields, **over), _data(fields)
    return (jax_get_model(name)(JaxConfig(conf), data=data),
            get_model(name)(Config(conf), data=data, device="cpu"))


def _carry(jstate):
    sums = None
    if jstate.opt and hasattr(jstate.opt[0], "sum_of_squares"):
        sums = {k: np.asarray(v) for k, v in jstate.opt[0].sum_of_squares.items()}
    return convert.ctr_state_from_numpy(
        np.asarray(jstate.table.table), {k: np.asarray(v) for k, v in jstate.dense.items()},
        sums, device="cpu",
        table_slots={k: np.asarray(v) for k, v in jstate.table.slots.items()})


def _arrays(table_state, dense):
    out = {"table": np.array(table_state.table)}
    out.update({f"slot.{k}": np.array(v) for k, v in table_state.slots.items()})
    out.update({f"dense.{k}": np.array(v) for k, v in dense.items()})
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_three_steps_match_jax(case):
    jt, tt = _pair(case)
    assert not jt.packed and not tt.packed
    assert tt.table_geometry() == jt.table_geometry()
    jstate = jt.init_state()
    state = _carry(jstate)
    start = _arrays(state.table, state.dense)
    assert state.table.table.shape == (tt.capacity, tt.table_dim)
    step = jax.jit(jt.train_step)
    batches = [b for _, b in zip(range(STEPS), tt.batches())]
    for i, (b, jb) in enumerate(zip(batches, jt.batches())):
        np.testing.assert_array_equal(b["feats"], jb["feats"])
        jstate, jm = step(jstate, {k: jnp.asarray(v) for k, v in jb.items()},
                          jax.random.PRNGKey(i))
        state, m = tt.train_step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
    got = _arrays(state.table, state.dense)
    want = _arrays(jstate.table, jstate.dense)
    assert set(got) == set(want)
    for k in want:
        moved = want[k] - start[k]
        scale = float(np.abs(moved).max())
        assert scale > 1e-4, (k, scale)
        np.testing.assert_allclose(got[k] - start[k], moved, rtol=0,
                                   atol=DELTA_RTOL * scale, err_msg=k)
    feats = _data(CASES[case][1])[1][:300]
    np.testing.assert_allclose(tt.predict(state, feats), jt.predict(jstate, feats),
                               rtol=1e-4, atol=1e-5)


def test_wide_ffm_trains_in_the_loop_and_launches_no_kernel():
    _, tt = _pair("ffm_wide")
    counters = [rowdma.gather_rows, rowdma.scatter_add_rows, rowdma.scatter_adagrad_fused_rows]
    before = [f.launches for f in counters]
    records = []

    class Rec:
        def count(self, n):
            pass

        def flush_window(self, **kw):
            records.append(kw)

    state = TrainLoop(tt, metrics=Rec(), log_every=1).run()
    assert [f.launches for f in counters] == before
    assert records[0]["producer"] == "python"  # records given in hand
    assert len(records) == 4 and torch.isfinite(state.table.table).all()
    assert set(state.table.slots) == {"accum"}


def test_export_text_matches_jax(tmp_path):
    jt, tt = _pair("widedeep")
    jstate = jt.init_state()
    jt.export_text(jstate, str(tmp_path / "j.txt"))
    tt.export_text(_carry(jstate), str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    export_table_text(_carry(jstate).table.table[:4], str(tmp_path / "rows.txt"))
    assert len((tmp_path / "rows.txt").read_text().splitlines()) == 4
