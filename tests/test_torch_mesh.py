"""The port's (client, data) mesh of ranks (``feddat_tpu_torch/parallel/mesh.py``)
against ``feddat_tpu/parallel/mesh.py`` on the CPU: the same grids (ranks in
place of the conftest's CPU devices; JAX's multi-host layout on fake devices)
and the same errors word for word; a world of one in this process (gloo from
a file store): its mesh, groups and teardown; ``--multihost`` without a
rendezvous; ``any_process_requested`` in a world of one."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from feddat_tpu.parallel import mesh as jmesh
from feddat_tpu_torch.parallel import mesh as tmesh
from feddat_tpu_torch.utils.preemption import GracefulPreemption

CPU = torch.device("cpu")


@dataclasses.dataclass(frozen=True)
class FakeDev:
    id: int
    process_index: int


@pytest.mark.parametrize("clients,data,n", [(1, None, 1), (2, None, 8), (4, 2, 8), (2, 4, 8),
                                            (8, 1, 8), (1, 8, 8)])
def test_grid_is_jaxs_with_ranks_for_devices(clients, data, n):
    want = jmesh.make_mesh(clients, data, devices=jax.devices()[:n]).devices
    got = tmesh.mesh_grid(clients, data, world_size=n)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, np.vectorize(lambda d: d.id)(want))


@pytest.mark.parametrize("clients,data,n", [(3, None, 8), (2, 2, 3), (4, 4, 8), (2, 1, 1)])
def test_errors_are_jaxs_word_for_word(clients, data, n):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(clients, data, devices=jax.devices()[:n])
    with pytest.raises(ValueError) as got:
        tmesh.mesh_grid(clients, data, world_size=n)
    assert str(got.value) == str(want.value)


def test_a_mesh_must_take_every_rank_and_has_no_model_axis():
    """Every rank needs a slot; a model axis of 1 adds no axis (JAX's 2-D
    mesh), one of 2 is the innermost third axis."""
    with pytest.raises(ValueError, match="takes 2 of the world.s 4 ranks; every rank needs a slot"):
        tmesh.mesh_grid(1, 2, world_size=4)
    with pytest.raises(ValueError, match=r"a \(1, 1, 2\) mesh takes 2 of the world.s 4 ranks"):
        tmesh.mesh_grid(1, 1, world_size=4, model_parallel=2)
    assert tmesh.mesh_grid(1, 2, world_size=2, model_parallel=1).shape == (1, 2)
    np.testing.assert_array_equal(tmesh.mesh_grid(1, 1, world_size=2, model_parallel=2),
                                  [[[0, 1]]])


@pytest.mark.parametrize("clients,data,model,n", [(2, 2, 2, 8), (2, None, 2, 8), (1, None, 4, 8),
                                                  (2, 1, 2, 4), (4, 1, 2, 8)])
def test_model_axis_grid_is_jaxs_with_ranks_for_devices(clients, data, model, n):
    want = jmesh.make_mesh(clients, data, devices=jax.devices()[:n], model_parallel=model)
    got = tmesh.mesh_grid(clients, data, world_size=n, model_parallel=model)
    assert want.axis_names == ("client", "data", "model")
    np.testing.assert_array_equal(got, np.vectorize(lambda d: d.id)(want.devices))


@pytest.mark.parametrize("clients,data,model,n", [(3, None, 2, 8), (2, 2, 4, 8), (1, None, 3, 8)])
def test_model_axis_errors_are_jaxs_word_for_word(clients, data, model, n):
    with pytest.raises(ValueError) as want:
        jmesh.make_mesh(clients, data, devices=jax.devices()[:n], model_parallel=model)
    with pytest.raises(ValueError) as got:
        tmesh.mesh_grid(clients, data, world_size=n, model_parallel=model)
    assert str(got.value) == str(want.value)


def _fake(num_hosts, per_host, interleave=False):
    devs = [FakeDev(h * per_host + i, h) for h in range(num_hosts) for i in range(per_host)]
    if interleave:
        devs = sorted(devs, key=lambda d: (d.id % per_host, d.process_index))
    return devs


@pytest.mark.parametrize("hosts,per,clients,data,interleave", [
    (4, 4, 8, 2, False), (2, 4, 2, 4, True), (2, 2, 1, 4, False), (2, 4, 4, None, False)])
def test_multihost_grid_and_host_split_are_jaxs(hosts, per, clients, data, interleave):
    devs = _fake(hosts, per, interleave)
    want = jmesh.arrange_multihost_grid(devs, lambda d: d.process_index, clients, data)
    host_of = {d.id: d.process_index for d in devs}
    got = tmesh.arrange_multihost_grid([d.id for d in devs], host_of.__getitem__, clients, data)
    np.testing.assert_array_equal(got, np.vectorize(lambda d: d.id)(want))
    for h in range(hosts):
        assert (tmesh.clients_for_process(got, host_of.__getitem__, h)
                == jmesh.clients_for_process(want, lambda d: d.process_index, h))


def test_multihost_grid_errors_are_jaxs():
    devs = _fake(2, 4)
    for clients, data in ((3, None), (4, 4)):
        with pytest.raises(ValueError) as want:
            jmesh.arrange_multihost_grid(devs, lambda d: d.process_index, clients, data)
        with pytest.raises(ValueError) as got:
            tmesh.arrange_multihost_grid(range(8), lambda r: r // 4, clients, data)
        assert str(got.value) == str(want.value)


def test_a_world_of_one_in_process():
    """``world`` starts gloo from a file store and tears it down; inside, the
    mesh is one slot whose groups hold rank 0, a larger mesh raises JAX's
    error, a group already there is kept, and any_process_requested is the
    local flag."""
    assert not dist.is_initialized()
    with tmesh.world(CPU) as size:
        assert size == 1 and dist.get_backend() == "gloo"
        mesh = tmesh.make_mesh(1, device_type="cpu")
        assert (mesh.client_index, mesh.data_index, mesh.shape) == (0, 0, {"client": 1, "data": 1})
        assert dist.get_process_group_ranks(mesh.client_group) == [0]
        assert dist.get_process_group_ranks(mesh.data_group) == [0]
        with pytest.raises(ValueError, match="^need 2 devices, have 1$"):
            tmesh.make_mesh(2, 1, device_type="cpu")
        assert tmesh.make_multihost_mesh(1, device_type="cpu").grid.tolist() == [[0]]
        with tmesh.world(CPU):  # an initialised group is used as it is
            pass
        assert dist.is_initialized()
        stop = GracefulPreemption()
        assert stop.any_process_requested() is False
        stop.requested = True
        assert stop.any_process_requested() is True
    assert not dist.is_initialized()


def test_multihost_without_a_rendezvous_raises(monkeypatch):
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="refusing to fall back to a world of one"):
        tmesh.initialize_multihost(device=CPU)
    with pytest.raises(RuntimeError, match=r"process id \(RANK\)"):
        tmesh.initialize_multihost("localhost:1", 2, device=CPU)
    assert not dist.is_initialized()


def test_multihost_defaults_to_the_card(monkeypatch):
    """With a rendezvous but no ``device``, a host without a card raises
    instead of starting a gloo group on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.initialize_multihost("localhost:1", 1, 0)
    assert not dist.is_initialized()
