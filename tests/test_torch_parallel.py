"""The port's parallel/ package in one process: the mesh against the JAX
package's, the block-row split, the refusals, the launcher's variables, and
the pieces of the sharded update that need no group (the salt shift, a row
range of the chunked update, the fused step's update_impl and sr_rng).

The spawned gloo groups are in tests/test_torch_distributed.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from intact_tpu.parallel import mesh as jmesh
from intact_tpu_torch.ops.fused_adam import hash_noise_u16, shift_salt
from intact_tpu_torch.parallel import AXIS_NAMES, MeshConfig, default_mesh_for, local_rows, make_mesh, row_shard
from intact_tpu_torch.parallel import distributed, sharding
from intact_tpu_torch.parallel.mesh import refuse_tensor
from intact_tpu_torch.train import fused_joint as fj
from intact_tpu_torch.train.optim import OptimizerConfig


def bits(x: torch.Tensor) -> torch.Tensor:
    """A tensor's bytes (fp8 tensors compare through them)."""
    return x.contiguous().view(-1).view(torch.uint8)


@pytest.mark.parametrize("cfg,n", [
    ((-1, 1, 1), 1), ((-1, 4, 1), 4), ((-1, 4, 1), 8), ((-1, 2, 2), 8), ((2, 2, 1), 4), ((1, 1, 1), 1),
    ((-1, 4, 1), 1), ((-1, 4, 1), 6), ((3, 3, 1), 8), ((2, 1, 1), 1), ((-1, 3, 1), 4), ((1, 2, 1), 4),
])
def test_mesh_config_resolves_as_the_jax_one(cfg, n):
    """The same shape, or the same ValueError with the same text."""
    want = got = None
    try:
        want = jmesh.MeshConfig(*cfg).resolve(n)
    except ValueError as e:
        want = str(e)
    try:
        got = MeshConfig(*cfg).resolve(n)
    except ValueError as e:
        got = str(e)
    assert got == want


def test_axis_names_and_default_mesh_match_jax():
    assert AXIS_NAMES == jmesh.AXIS_NAMES
    assert [f.name for f in dataclasses.fields(MeshConfig)] == [f.name for f in dataclasses.fields(jmesh.MeshConfig)]
    for n in range(1, 17):
        assert dataclasses.astuple(default_mesh_for(n)) == dataclasses.astuple(jmesh.default_mesh_for(n)), n


@pytest.mark.parametrize("n,block,parts,align", [
    (10, 3, 4, 1), (4096, 2048, 2, 1), (1024, 2048, 2, 1), (7 * 2048 + 5, 2048, 4, 1), (2048 * 384, 2048, 4, 128),
    (2048 * 128, 2048, 4, 128), (2048 * 640, 2048, 3, 128), (5, 8, 1, 1), (9000, 2048, 8, 1),
])
def test_row_shards_split_the_global_block_rows(n, block, parts, align):
    """The ranks' shares are disjoint, cover rows [0, nb) and elements
    [0, n) in rank order, start on `align` rows, hold at most `per` rows (the
    last ones short or empty), and one part is the whole leaf."""
    shards = [row_shard(n, block, parts, i, align) for i in range(parts)]
    nb = -(-n // block)
    per = shards[0].per
    assert per % align == 0 and per * parts >= nb and (per - align) * parts < nb
    assert [s.r0 for s in shards][0] == 0 and shards[-1].r1 == nb
    for a, b in zip(shards, shards[1:]):
        assert a.r1 == b.r0 and a.e1 == b.e0
    for s in shards:
        assert 0 <= s.rows <= per and s.r0 % align == 0 and s.e1 - s.e0 == min(s.rows * block, n - s.e0)
    assert sum(s.e1 - s.e0 for s in shards) == n and shards[0].e0 == 0
    assert row_shard(n, block, 1, 0, align).whole and row_shard(n, block, 1, 0, align).rows == nb


def test_gather_and_take_invert_each_other_without_a_group():
    """take_leading cuts a rank's zero-padded share of a global tensor along
    an axis; gather_leading without a group returns the global view again."""
    x = torch.arange(2 * 7 * 3).view(2, 7, 3)
    shards = [row_shard(7 * 3, 3, 3, i) for i in range(3)]
    parts = [sharding.take_leading(x, s, s.per, axis=1) for s in shards]
    assert all(p.shape == (2, 3, 3) for p in parts)
    assert torch.equal(torch.cat(parts, dim=1)[:, :7], x) and not parts[-1][:, 1:].any()
    one = make_mesh()
    assert torch.equal(sharding.gather_leading(x, one, 7, axis=1), x)


def test_local_rows():
    batch = {"a": np.arange(8).reshape(4, 2), "b": {"c": torch.arange(4)}}
    assert np.array_equal(local_rows(batch, 1, 2)["a"], [[4, 5], [6, 7]])
    assert torch.equal(local_rows(batch, 3, 4)["b"]["c"], torch.tensor([3]))
    with pytest.raises(ValueError, match="does not split"):
        local_rows(batch, 0, 3)


def test_make_mesh_without_a_group():
    """One process, no launcher: a world of one. The repo's fsdp 4 mesh does
    not fit it (the JAX package's error), nor a tensor-2 mesh; the tensor axis
    is refused for training a family outside the tensor-parallel slice (Octo)."""
    mesh = make_mesh(MeshConfig())
    assert mesh.shape == {"data": 1, "fsdp": 1, "tensor": 1} and mesh.size == 1 and not mesh.distributed
    assert (mesh.rank, mesh.fsdp_index, mesh.tensor_index, mesh.batch_index, mesh.batch_size) == (0, 0, 0, 0, 1)
    with pytest.raises(ValueError, match="1 devices not divisible by fsdp\\*tensor=4"):
        make_mesh(MeshConfig(data=-1, fsdp=4))
    with pytest.raises(ValueError, match="1 devices not divisible by fsdp\\*tensor=2"):
        make_mesh(MeshConfig(data=-1, fsdp=1, tensor=2))
    with pytest.raises(NotImplementedError, match="tensor axis"):
        refuse_tensor(MeshConfig(data=-1, fsdp=1, tensor=2), "octo")
    assert distributed.process_mean({"b": 2.0, "a": 1.0}) == {"b": 2.0, "a": 1.0}
    assert np.array_equal(distributed.broadcast_from_host0(np.arange(3)), np.arange(3))
    assert (distributed.process_index(), distributed.process_count(), distributed.backend()) == (0, 1, None)


@pytest.mark.parametrize("env,want", [
    ({"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "MASTER_ADDR": "10.0.0.2", "MASTER_PORT": "1234"},
     {"rank": 3, "world": 4, "local_rank": 1, "addr": "10.0.0.2", "port": 1234}),
    ({"COORDINATOR_ADDRESS": "host-a:8476", "NUM_PROCESSES": "2", "PROCESS_ID": "1"},
     {"rank": 1, "world": 2, "local_rank": 1, "addr": "host-a", "port": 8476}),
    ({}, None),
])
def test_launcher_variables(monkeypatch, env, want):
    """torchrun's variables, or the JAX package's mapped onto them."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "COORDINATOR_ADDRESS",
              "NUM_PROCESSES", "PROCESS_ID"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert distributed._launch_env() == want


def test_initialize_without_a_launcher_joins_nothing(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("offset_rows", [0, 1, 5, 127])
def test_shifted_salt_gives_a_row_range_the_whole_leafs_noise(offset_rows):
    width, rows = 16, 200
    whole = hash_noise_u16((rows, width), 0xDEADBEEF)
    part = hash_noise_u16((rows - offset_rows, width), shift_salt(0xDEADBEEF, offset_rows * width))
    assert torch.equal(part, whole[offset_rows:])


def test_chunked_update_on_row_ranges_is_the_whole_leafs():
    """_chunked_quant_update over a leaf's rows in three ranges (one crossing
    a chunk boundary) equals the update of the whole leaf, bit for bit, with
    stochastic rounding to bf16."""
    rng = np.random.default_rng(0)
    nb, blk = 11, 8
    p = torch.from_numpy(rng.standard_normal((nb, blk), dtype=np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.standard_normal((nb, blk), dtype=np.float32)).to(torch.bfloat16)
    qm = torch.from_numpy(rng.uniform(-400, 400, (nb, blk)).astype(np.float32)).to(torch.float8_e4m3fn)
    qn = torch.from_numpy(rng.uniform(0, 400, (nb, blk)).astype(np.float32)).to(torch.float8_e5m2)
    sm = torch.from_numpy(rng.uniform(1e-4, 1e-3, (nb, 1)).astype(np.float32))
    sn = torch.from_numpy(rng.uniform(1e-6, 1e-5, (nb, 1)).astype(np.float32))
    kw = dict(c1=torch.tensor(0.19), c2=torch.tensor(0.003), lr=torch.tensor(1e-3), clip_factor=torch.tensor(0.7),
              hp=OptimizerConfig(weight_decay=1e-2), key=77, stochastic=True, block_size=blk, rows_chunk=4,
              scale_mode="bound")
    whole = fj._chunked_quant_update(p, g, qm, sm, qn, sn, **kw)
    parts = [fj._chunked_quant_update(p[a:b], g[a:b], qm[a:b], sm[a:b], qn[a:b], sn[a:b], row0=a, nb_total=nb, **kw)
             for a, b in ((0, 3), (3, 9), (9, 11))]
    for w, *ps in zip(whole, *parts):
        assert torch.equal(bits(w), bits(torch.cat(ps)))


def test_fused_step_options_are_checked():
    from intact_tpu_torch.models.pi0.config import Pi0Config

    cfg = Pi0Config.tiny()
    with pytest.raises(ValueError, match="update_impl must be leaf\\|packed\\|hybrid"):
        fj.make_fused_joint_step(cfg, OptimizerConfig(), update_impl="scan")
    with pytest.raises(ValueError, match="sr_rng must be hash\\|rbg\\|threefry"):
        fj.make_fused_joint_step(cfg, OptimizerConfig(), sr_rng="philox")
    for rng in ("rbg", "threefry"):
        with pytest.raises(NotImplementedError, match="cannot be reproduced"):
            fj.make_fused_joint_step(cfg, OptimizerConfig(), sr_rng=rng)
        fj.make_fused_joint_step(cfg, OptimizerConfig(), sr_rng=rng, stochastic_rounding=False)  # draws nothing


@pytest.mark.parametrize("impl", ["packed", "hybrid"])
def test_fused_update_impls_update_as_leaf(impl):
    """update_impl "packed" and "hybrid" update every leaf as "leaf" does, bit
    for bit: two steps, bf16 with stochastic rounding, through the row
    kernel's wrapper (its plain version on the CPU) at block 8."""
    from intact_tpu_torch.models import common as cm
    from intact_tpu_torch.models.pi0 import model as pi0
    from intact_tpu_torch.models.pi0.config import Pi0Config

    cfg = Pi0Config.tiny()
    policy = cm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(3)
    s = cfg.vision.image_size
    batch = {"images": torch.from_numpy(rng.uniform(-1, 1, (2, 1, s, s, 3)).astype(np.float32)),
             "img_masks": torch.ones(2, 1, dtype=torch.bool),
             "lang_tokens": torch.from_numpy(rng.integers(0, 256, (2, cfg.tokenizer_max_length)).astype(np.int32)),
             "lang_masks": torch.ones(2, cfg.tokenizer_max_length, dtype=torch.bool),
             "state": torch.from_numpy(rng.standard_normal((2, cfg.max_state_dim), dtype=np.float32)),
             "actions": torch.from_numpy(rng.standard_normal((2, cfg.chunk_size, cfg.max_action_dim),
                                                             dtype=np.float32))}
    states = {}
    for name in ("leaf", impl):
        params = pi0.init(cfg, seed=0, device="cpu", dtype=torch.bfloat16)
        state = fj.init_fused_state(params, seed=1, block_size=8, min_quant_elems=64)
        step = fj.make_fused_joint_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=0), policy, block_size=8,
                                        update_impl=name)
        for _ in range(2):
            state, _ = step(state, batch)
        states[name] = state
    for tree in ("params", "mu", "nu"):
        a, b = cm.flatten_paths(getattr(states["leaf"], tree)), cm.flatten_paths(getattr(states[impl], tree))
        assert set(a) == set(b)
        for k, v in a.items():
            assert torch.equal(bits(v), bits(b[k])), (tree, k)
