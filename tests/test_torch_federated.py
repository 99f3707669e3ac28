"""The port's sequential FederatedTrainer against the JAX engine on the CPU,
in float32: two synthetic clients, two rounds of the fused DAT step with
FedAvg of adapter_1 and ``evaluate_dat`` after each round.  Compared: the
server's adapter_1, each client's personal partition (adapter_0, the
teacher adapter_2, the head) and the three-mode scores.

Tolerances: parameters rtol=1e-4 and atol=1e-4 = lr/50.  Adam divides each
gradient element by its own running RMS, so where a gradient is near zero
its summation-order error (the two frameworks sum in other orders) becomes
a difference of up to a whole step of size lr in that element; over 2
rounds x 2 steps this moved one element of 256 by 2.3e-5.  Scores exactly
(each is a count of argmax hits over 8 examples, times 100/8)."""

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from feddat_tpu.configs.core import FederatedConfig as JaxFederatedConfig
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import TrainConfig as JaxTrainConfig
from feddat_tpu.data.synthetic import SyntheticVQAClient as JaxClient
from feddat_tpu.federated.engine import FederatedTrainer as JaxTrainer
from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.data.synthetic import SyntheticVQAClient
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.federated.fedavg import fedavg
from feddat_tpu_torch.parallel.mesh import world
from feddat_tpu_torch.parallel.tp import make_tp_mesh
from feddat_tpu_torch.utils.param_bridge import vilt_from_flax

from conftest import TINY_VILT
from test_torch_vilt import jax_model_and_params, port_model

CLIENT = dict(num_train=8, num_eval=8, num_labels=16, vocab_size=TINY_VILT.vocab_size,
              text_len=TINY_VILT.max_text_len, image_size=TINY_VILT.image_size, batch_size=4)
HEADS = {f"c{i}": dict(num_labels=16) for i in range(2)}
OPT = dict(lr=5e-3)
ROUNDS = 2


def _cfg(mod):
    return mod["TrainConfig"](
        peft_mode=mod["PEFTMode"].DAT, optimizer=mod["OptimizerConfig"](**OPT),
        federated=mod["FederatedConfig"](comm_rounds=ROUNDS, local_epochs=1, eval_every=1),
        num_epochs=2, seed=0)


def test_synthetic_client_twin_is_bitwise_equal():
    a, b = JaxClient("c", seed=3, **CLIENT), SyntheticVQAClient("c", seed=3, **CLIENT)
    for ja, tb in zip([*a.train_batches(1), *a.eval_batches()], [*b.train_batches(1), *b.eval_batches()]):
        assert ja.keys() == tb.keys()
        for k in ja:
            np.testing.assert_array_equal(ja[k], tb[k])


def test_fedavg_weighted_average():
    trees = [{"a": torch.ones(2) * v} for v in (1.0, 3.0)]
    assert torch.allclose(fedavg(trees)["a"], torch.full((2,), 2.0))
    assert torch.allclose(fedavg(trees, [3.0, 1.0])["a"], torch.full((2,), 1.5))
    with pytest.raises(ValueError, match="client_weights"):
        fedavg(trees, [1.0])


@pytest.fixture(scope="module")
def runs():
    jmodel, params = jax_model_and_params(TINY_VILT, heads=HEADS)
    jclients = {k: JaxClient(k, seed=i, **CLIENT) for i, k in enumerate(HEADS)}
    jcfg = _cfg(dict(TrainConfig=JaxTrainConfig, PEFTMode=JaxPEFTMode,
                     OptimizerConfig=JaxOptimizerConfig, FederatedConfig=JaxFederatedConfig))
    jt = JaxTrainer(jmodel, params, jclients, jcfg, use_fused_dat=True)
    jt.run(resume=False)

    tmodel = port_model(TINY_VILT, params, "layer", HEADS)
    tclients = {k: SyntheticVQAClient(k, seed=i, **CLIENT) for i, k in enumerate(HEADS)}
    tcfg = _cfg(dict(TrainConfig=TrainConfig, PEFTMode=PEFTMode, OptimizerConfig=OptimizerConfig,
                     FederatedConfig=FederatedConfig))
    tt = FederatedTrainer(tmodel, None, tclients, tcfg, use_fused_dat=True, device="cpu")
    tt.run()
    return jt, tt


def _assert_close(got, want_tree, what):
    want = vilt_from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=OPT["lr"] / 50, err_msg=f"{what}: {k}")


def test_server_adapter_1_matches_jax(runs):
    jt, tt = runs
    flat = traverse_util.flatten_dict(jt.server_params)
    shared = traverse_util.unflatten_dict({p: v for p, v in flat.items() if "adapter_1" in "/".join(p)})
    got = {k: v for k, v in tt.server_params.items() if "adapter_1" in k}
    _assert_close(got, shared, "server adapter_1")
    assert len(got) == 4 * TINY_VILT.num_layers


def test_personal_partitions_match_jax(runs):
    jt, tt = runs
    for key in HEADS:
        _assert_close(tt.personal[key], jt.personal[key], f"{key} personal")
    a0 = [tt.personal[k]["vilt.layers.0.adapter.adapter_0_up.bias"] for k in HEADS]
    assert not torch.equal(*a0)  # personal, not averaged


def test_evaluate_dat_scores_match_jax(runs):
    jt, tt = runs
    assert len(tt.history) == len(jt.history) == ROUNDS
    for je, te in zip(jt.history, tt.history):
        assert te["round"] == je["round"]
        for key in HEADS:
            assert len(te["scores"][key]) == 3
            np.testing.assert_allclose(te["scores"][key], je["scores"][key], rtol=0, atol=1e-9)


def test_later_slice_options_raise():
    model = port_model(TINY_VILT, jax_model_and_params(TINY_VILT, heads=HEADS)[1], "auto", HEADS)
    clients = {k: SyntheticVQAClient(k, seed=i, **CLIENT) for i, k in enumerate(HEADS)}
    cfg = _cfg(dict(TrainConfig=TrainConfig, PEFTMode=PEFTMode, OptimizerConfig=OptimizerConfig,
                    FederatedConfig=FederatedConfig))
    # a (data=1, model=1) mesh in a world of one runs what the engine without one runs
    with world(torch.device("cpu")):
        plain = FederatedTrainer(model, None, clients, cfg, device="cpu")
        plain.run_round(0)
        with_mesh = FederatedTrainer(model, None, clients, cfg, device="cpu",
                                     tp_mesh=make_tp_mesh(1, device_type="cpu"))
        with_mesh.run_round(0)
    for k, v in plain.server_params.items():
        assert torch.equal(v, with_mesh.server_params[k]), k
    with pytest.raises(TypeError, match="federated engine trains ViltContinualLearner, .*; got Linear"):
        FederatedTrainer(torch.nn.Linear(2, 2), None, clients, cfg, device="cpu")


def test_single_task_baseline_leaves_the_trainer_as_it_started():
    """``run_single_task`` (main.py:402-436): each task trains alone from the
    initial parameters and is scored in the three DAT modes; the server and
    personal store come back unchanged."""
    model = port_model(TINY_VILT, jax_model_and_params(TINY_VILT, heads=HEADS)[1], "layer", HEADS)
    clients = {k: SyntheticVQAClient(k, seed=i, **CLIENT) for i, k in enumerate(HEADS)}
    cfg = _cfg(dict(TrainConfig=TrainConfig, PEFTMode=PEFTMode, OptimizerConfig=OptimizerConfig,
                    FederatedConfig=FederatedConfig))
    trainer = FederatedTrainer(model, None, clients, cfg, use_fused_dat=True, device="cpu")
    server, personal = dict(trainer.server_params), {k: dict(v) for k, v in trainer.personal.items()}
    entry = trainer.run_single_task()
    assert entry["single_task"] and set(entry["scores"]) == set(HEADS)
    assert all(len(v) == 3 for v in entry["scores"].values())
    assert all(trainer.server_params[k] is v for k, v in server.items())
    assert all(trainer.personal[c][k] is v for c in personal for k, v in personal[c].items())
