"""``--encoder_name albef_distill`` through the port's CLI against the JAX
package's on the CPU, in the tests/test_torch_cli_albef.py pattern (one task
written to disk here, ``--smoke --dtype float32``, JAX's initial parameters
carried across by ``utils/param_bridge.py``):

* ``--optimizer_mode adapter``: momentum distillation on the plain step, one
  round of 2 steps; the step records' losses (rtol 1e-4), the rank-answer
  scores (atol 1e-9) and the server parameters (rtol 1e-4, atol lr/50);
* ``--optimizer_mode dat --use_fused_dat``: both run the fused DAT step, which
  takes no twin, with the same step losses;
* ``--optimizer_mode dat`` (the standard step): both raise ``TypeError`` at
  the first step (the distill forward takes the twin, the step passes none);
* ``--engine spmd``: both raise ``NotImplementedError`` (JAX once the model
  is built, the port before anything is built)."""

import json
import pickle

import jax
import numpy as np
import pytest

import feddat_tpu.cli as jcli
import feddat_tpu_torch.cli as tcli
from feddat_tpu_torch.utils.param_bridge import albef_from_flax

from test_torch_cli import TASK, _one, _records, write_task
from test_torch_cli_albef import ANSWERS, LR, albef_argv


def distill_argv(data_root, vocab_file, out, mode, *extra):
    argv = albef_argv(data_root, vocab_file, out, *extra)
    argv[argv.index("albef_no_distill")] = "albef_distill"
    argv[argv.index("--optimizer_mode") + 1] = mode
    if mode != "dat":
        argv.remove("--use_fused_dat")
    return argv


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_cli_distill")
    data_root, vocab_file = write_task(root)
    with open(data_root / TASK / "ans2label.pkl", "wb") as f:
        pickle.dump({c: i for i, c in enumerate(ANSWERS)}, f)
    return root, data_root, vocab_file


def _both(task, name, mode, *extra, port_extra=()):
    """Run both CLIs from JAX's initial parameters -> (JAX's out, the port's out)."""
    import feddat_tpu.models.albef as ja

    root, data_root, vocab_file = task
    out_j, out_t = root / f"{name}_jax", root / f"{name}_port"
    seen, init = {}, ja.init_albef_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ja, "init_albef_params", lambda *a, **kw: seen.setdefault("params", init(*a, **kw)))
        assert jcli.main(distill_argv(data_root, vocab_file, out_j, mode, *extra)) == 0
        start = albef_from_flax(jax.tree_util.tree_map(np.asarray, seen["params"]))
        mp.setattr(tcli, "init_params", lambda args, model, cfg: dict(start))
        assert tcli.main(distill_argv(data_root, vocab_file, out_t, mode, *extra, "--device", "cpu",
                                      *port_extra)) == 0
    return out_j, out_t


def _same_steps(out_j, out_t, n):
    j_steps, t_steps = _records(out_j, "step"), _records(out_t, "step")
    assert len(t_steps) == len(j_steps) == n
    for j, t in zip(j_steps, t_steps):
        assert t.keys() == j.keys()
        for k in j:
            if k in ("loss", "loss_shared", "lr"):
                np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"step {j['step']}: {k}")


def test_distill_adapter_run_matches_jax(task):
    from feddat_tpu.utils.checkpointing import restore_federated_state as jax_restore
    from feddat_tpu_torch.utils.checkpointing import restore_federated_state

    out_j, out_t = _both(task, "adapter", "adapter")
    _same_steps(out_j, out_t, 2)
    j_hist, t_hist = (json.loads((o / "logs" / _one(o / "logs", ".history.json")).read_text())
                      for o in (out_j, out_t))
    assert _one(out_t / "logs", ".history.json").startswith("albef_distill_adapter_")
    np.testing.assert_allclose(t_hist[0]["scores"][TASK], j_hist[0]["scores"][TASK], rtol=0, atol=1e-9)
    _, server_j, _, _ = jax_restore(str(out_j / "ckpt"))
    _, server_t, _, _ = restore_federated_state(str(out_t / "ckpt"), device="cpu")
    want = albef_from_flax(jax.tree_util.tree_map(np.asarray, server_j))
    assert server_t.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(server_t[k].numpy(), want[k].numpy(), rtol=1e-4, atol=LR / 50,
                                   err_msg=k)
    assert (out_t / "ckpt" / "meta.json").read_bytes() == (out_j / "ckpt" / "meta.json").read_bytes()


def test_distill_with_the_fused_dat_step_runs_as_jax(task):
    out_j, out_t = _both(task, "fused", "dat")
    _same_steps(out_j, out_t, 2)


def test_distill_with_the_standard_dat_step_raises_as_jax(task):
    """Both CLIs reach the first step and raise ``TypeError`` there."""
    _, data_root, vocab_file = task
    root = task[0]
    errors = []
    for main, extra in ((jcli.main, ()), (tcli.main, ("--device", "cpu"))):
        argv = distill_argv(data_root, vocab_file, root / f"std_{len(errors)}", "dat", *extra)
        argv.remove("--use_fused_dat")
        with pytest.raises(TypeError) as err:
            main(argv)
        errors.append(str(err.value))
    assert all("missing 1 required positional argument: 'aux'" in e for e in errors), errors


def test_distill_with_spmd_raises_as_jax(task, monkeypatch):
    """JAX raises ``NotImplementedError`` after building the model; the port
    raises it, with JAX's words, before building anything."""
    _, data_root, vocab_file = task
    root = task[0]
    with pytest.raises(NotImplementedError) as jerr:
        jcli.main(distill_argv(data_root, vocab_file, root / "spmd_jax", "dat", "--engine", "spmd"))

    def never(*a, **kw):
        raise AssertionError("a model or client was built")

    for fn in ("build_model", "build_clients", "init_params"):
        monkeypatch.setattr(tcli, fn, never)
    with pytest.raises(NotImplementedError) as terr:
        tcli.main(distill_argv(data_root, vocab_file, root / "spmd_port", "dat", "--engine", "spmd",
                               "--device", "cpu"))
    assert str(terr.value) == str(jerr.value)
    assert not (root / "spmd_port").exists()
