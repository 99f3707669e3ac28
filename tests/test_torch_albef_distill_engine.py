"""ALBEF momentum distillation through the engines and with dropout live,
the port against the JAX package on the CPU (the tiny adapter-mode ALBEF and
weights of tests/test_torch_albef_distill.py): the trainer registry and one
``albef_distill`` round through both engines (tests/test_distill_engine.py's
cases), and the plain distill step's losses by distribution with dropout
live.

Tolerances: the round as tests/test_torch_albef_train.py's: parameters
rtol=1e-4, atol=lr/50, scores atol 1e-9.  With dropout live: each loss mean
within 4 pooled standard errors of JAX's over 16 seeds."""

import dataclasses

import jax
import numpy as np
import torch

from feddat_tpu.configs.core import FederatedConfig as JaxFederatedConfig
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import TrainConfig as JaxTrainConfig
from feddat_tpu.data.synthetic import SyntheticAlbefClient as JaxAlbefClient
from feddat_tpu.federated.engine import FederatedTrainer as JaxTrainer
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.train import dat as jdat
from feddat_tpu.train.forwards import add_alpha as jax_add_alpha
from feddat_tpu.train.forwards import make_albef_distill_forward as jax_distill_forward
from feddat_tpu.train.trainers import albef_hooks as jax_albef_hooks
from feddat_tpu.train.trainers import resolve_trainer as jax_resolve_trainer
from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train import trainers
from feddat_tpu_torch.train.forwards import add_alpha, to_device
from feddat_tpu_torch.utils.param_bridge import albef_from_flax

from test_torch_albef import TINY
from test_torch_albef_distill import CPU, DISTILL, LR, _model, _port, _port_step, _sd, weights  # noqa: F401
from test_torch_albef_train import CLIENT, _train_batch

LIVE = dataclasses.replace(DISTILL, bert=dataclasses.replace(TINY.bert, hidden_dropout=0.3,
                                                             attention_dropout=0.3))


def _clients(mod, client_cls, n=1):
    return {f"c{i}": client_cls(task_key=f"c{i}", seed=i, **CLIENT) for i in range(n)}


def _cfg(mod, mode="ADAPTER"):
    return mod["TrainConfig"](
        encoder_name="albef_distill", peft_mode=getattr(mod["PEFTMode"], mode),
        optimizer=mod["OptimizerConfig"](lr=5e-3),
        federated=mod["FederatedConfig"](comm_rounds=1, local_epochs=1, eval_every=1),
        num_epochs=2, seed=0)


JAX_CFG = dict(TrainConfig=JaxTrainConfig, PEFTMode=JaxPEFTMode, OptimizerConfig=JaxOptimizerConfig,
               FederatedConfig=JaxFederatedConfig)
PORT_CFG = dict(TrainConfig=TrainConfig, PEFTMode=PEFTMode, OptimizerConfig=OptimizerConfig,
                FederatedConfig=FederatedConfig)


def test_trainer_registry_matches_jax():
    """tests/test_distill_engine.py::test_trainer_registry through both
    registries: the distill hooks (aux seed, alpha ramp, aux forward) for
    ``albef_distill`` alone."""
    banks = {"c0": (np.zeros((4, 3), np.int32), np.ones((4, 3), np.int32))}
    for resolve in (jax_resolve_trainer, trainers.resolve_trainer):
        h = resolve("vilt", "vqa_cross")
        assert h.metric == "vqa_score" and h.aux_init is None and not h.aux_forward
        assert resolve("vilt", "nlvr2").metric == "accuracy"
        h = resolve("albef_distill", "vqa_cross", answer_banks=banks)
        assert h.aux_forward and h.batch_transform is not None and h.aux_init is not None
        h = resolve("albef_no_distill", "vqa_cross", answer_banks=banks)
        assert not h.aux_forward and h.batch_transform is None and h.aux_init is None
    sd = {"a": torch.ones(2)}
    twin = trainers.resolve_trainer("albef_distill", "vqa", answer_banks=banks).aux_init(sd)
    assert twin == sd and twin is not sd


def test_albef_distill_round_matches_jax_engine(weights):
    """tests/test_distill_engine.py::test_albef_distill_adapter_mode_round
    through both engines from the same weights: one client, one round of
    plain distill steps with the alpha ramp, rank-answer evaluation (k=4).
    The server parameters, the scores, and only adapters moved."""
    jclients = _clients(JAX_CFG, JaxAlbefClient)
    banks = {k: (c.answer_ids, c.answer_mask) for k, c in jclients.items()}
    jh = jax_albef_hooks(banks, distill=True, rank_k=4)
    jt = JaxTrainer(JaxAlbef(DISTILL), weights, jclients, _cfg(JAX_CFG), make_forward=jh.make_forward,
                    make_eval=jh.make_eval, aux_init=jh.aux_init, batch_transform=jh.batch_transform,
                    aux_forward=jh.aux_forward)
    jt.run()

    clients = _clients(PORT_CFG, SyntheticAlbefClient)
    h = trainers.albef_hooks({k: (c.answer_ids, c.answer_mask) for k, c in clients.items()},
                             distill=True, rank_k=4)
    tt = FederatedTrainer(_model(weights), None, clients, _cfg(PORT_CFG), make_forward=h.make_forward,
                          make_eval=h.make_eval, aux_init=h.aux_init, batch_transform=h.batch_transform,
                          aux_forward=h.aux_forward, device="cpu")
    tt.run()
    want, init = _port(jt.server_params), albef_from_flax(weights)
    assert set(want) == set(tt.server_params)
    for k, v in want.items():
        np.testing.assert_allclose(tt.server_params[k].numpy(), v.numpy(), rtol=1e-4, atol=5e-3 / 50,
                                   err_msg=k)
    moved = {k for k in init if not torch.equal(init[k], tt.server_params[k])}
    assert moved and all(".adapter." in k for k in moved)
    assert moved == {k for k in init if not torch.equal(init[k], want[k])}
    (je,), (te,) = jt.history, tt.history
    np.testing.assert_allclose(te["scores"]["c0"], je["scores"]["c0"], rtol=0, atol=1e-9)


def test_distill_step_losses_match_jax_by_distribution(weights):
    """Dropout 0.3 live: the twin's forward draws from the step's first
    generator, the model's from its second (JAX splits the step's key in two),
    so the masks cannot match JAX's; over 16 seeds each of two steps' loss
    means lies within 4 pooled standard errors of JAX's."""
    batch, n = _train_batch(6), 16
    jopt = JaxOptimizerConfig(lr=LR)
    jpart = jdat.Partitioner(weights, "fed", JaxPEFTMode.ADAPTER)
    jstep = jdat.make_plain_train_step(jax_distill_forward(JaxAlbef(LIVE)), jpart, jopt, 100,
                                       "adapter", donate=False, aux_forward=True)
    model = _model(weights, LIVE)
    sd = _sd(model)
    step, part, opt = _port_step(model, sd)
    tbatch = to_device(batch, CPU)
    j, t = [], []
    for seed in range(n):
        js = jdat.init_train_state(weights, jpart, jopt, jax.random.PRNGKey(100 + seed)).replace(aux=weights)
        ts = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(100 + seed)).replace(
            aux=dict(sd))
        row_j, row_t = [], []
        for i in range(2):
            js, jm = jstep(js, jax_add_alpha(batch, 0, i + 1, 4))
            ts, tm = step(ts, add_alpha(tbatch, 0, i + 1, 4))
            row_j.append(float(jm["loss"]))
            row_t.append(float(tm["loss"]))
        j.append(row_j)
        t.append(row_t)
    j, t = np.array(j), np.array(t)
    assert j.std(axis=0).min() > 1e-6 and t.std(axis=0).min() > 1e-6
    se = np.sqrt((j.var(axis=0) + t.var(axis=0)) / n)
    diff = np.abs(j.mean(axis=0) - t.mean(axis=0))
    assert (diff < 4 * se + 1e-7).all(), (diff, 4 * se)
