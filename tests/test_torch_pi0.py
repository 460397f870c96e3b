"""The PyTorch port's Pi0 towers and sampler against the JAX package's, on the CPU.

Both run `Pi0Config.tiny()` in fp32 (`DtypePolicy(float32, float32)` on both
sides) on parameters made by the JAX `pi0.init` and carried across by
`intact_tpu_torch.convert.from_jax_params`; inputs and noise come from a
seeded numpy generator. Tolerance 1e-4 (abs and rel): fp32 matmuls and
reductions summed in another order drift by ~1e-6 per op over the tiny
towers' few dozen ops, and the sampler feeds 3 Euler steps back into itself.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from intact_tpu.models import common as jcm
from intact_tpu.models import gemma as jgemma
from intact_tpu.models import siglip as jsiglip
from intact_tpu.models.pi0 import model as jpi0
from intact_tpu.models.pi0.config import Pi0Config as JPi0Config
from intact_tpu.ops.masks import make_att_2d_masks as j_masks
from intact_tpu_torch import convert
from intact_tpu_torch.models import common as tcm
from intact_tpu_torch.models import gemma as tgemma
from intact_tpu_torch.models import siglip as tsiglip
from intact_tpu_torch.models.pi0 import model as tpi0
from intact_tpu_torch.models.pi0.config import Pi0Config as TPi0Config
from intact_tpu_torch.ops.masks import make_att_2d_masks as t_masks

TOL = 1e-4
J32 = jcm.DtypePolicy(param_dtype=jnp.float32, compute_dtype=jnp.float32)
T32 = tcm.DtypePolicy(param_dtype=torch.float32, compute_dtype=torch.float32)


@pytest.fixture(scope="module")
def cfgs():
    return JPi0Config.tiny(), TPi0Config.tiny()


@pytest.fixture(scope="module")
def jparams(cfgs):
    return jpi0.init(jax.random.key(0), cfgs[0])


@pytest.fixture(scope="module")
def tparams(cfgs, jparams):
    return convert.from_jax_params(jax.tree.map(np.asarray, jparams), cfgs[1], device="cpu")


@pytest.fixture(scope="module")
def batch(cfgs):
    cfg = cfgs[0]
    rng = np.random.default_rng(1)
    b, s = 2, cfg.vision.image_size
    lang_masks = np.zeros((b, cfg.tokenizer_max_length), bool)
    lang_masks[0, :5] = True
    lang_masks[1, :3] = True  # ragged language padding
    return {
        "images": rng.uniform(-1, 1, (b, cfg.num_cameras, s, s, 3)).astype(np.float32),
        "img_masks": np.ones((b, cfg.num_cameras), bool),
        "lang_tokens": rng.integers(0, 300, (b, cfg.tokenizer_max_length)).astype(np.int32),  # some out of vocab
        "lang_masks": lang_masks,
        "state": rng.standard_normal((b, cfg.max_state_dim), dtype=np.float32),
        "noise": rng.standard_normal((b, cfg.chunk_size, cfg.max_action_dim), dtype=np.float32),
    }


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32), np.asarray(b, np.float32), atol=tol, rtol=tol)


def prefix_inputs(cfgs, jparams, tparams, batch):
    """(JAX, port) embedded prefix + mask + positions for the same batch."""
    jc, tc = cfgs
    keys = ("images", "img_masks", "lang_tokens", "lang_masks")
    je, jpad, jatt = jpi0.embed_prefix(jparams, *(jnp.asarray(batch[k]) for k in keys), jc, J32)
    te, tpad, tatt = tpi0.embed_prefix(tparams, *(torch.from_numpy(batch[k]) for k in keys), tc, T32)
    close(te, je)
    np.testing.assert_array_equal(tpad.numpy(), np.asarray(jpad))
    jm, tm = j_masks(jpad, jatt), t_masks(tpad, tatt)
    jpos = jnp.cumsum(jpad.astype(jnp.int32), axis=1) - 1
    tpos = torch.cumsum(tpad.to(torch.int32), dim=1) - 1
    return (je, jm, jpos, jpad), (te, tm, tpos, tpad)


class TestWeightBridge:
    def test_fills_every_parameter(self, cfgs, jparams, tparams):
        jleaves = jax.tree_util.tree_leaves_with_path(jparams)
        assert len(jleaves) == len(tcm.tree_leaves(tparams))
        for path, leaf in jleaves:
            node = tparams
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))

    def test_raises_on_leftover_and_missing(self, cfgs, jparams):
        tree = jax.tree.map(np.asarray, jparams)
        with pytest.raises(ValueError, match="unconsumed"):
            convert.from_jax_params({**tree, "extra": np.zeros(3)}, cfgs[1], device="cpu")
        tree = dict(tree)
        del tree["img_proj"]
        with pytest.raises(ValueError, match="missing"):
            convert.from_jax_params(tree, cfgs[1], device="cpu")

    def test_raises_on_shape_mismatch(self, cfgs, jparams):
        tree = jax.tree.map(np.asarray, jparams)
        tree["state_proj"] = {**tree["state_proj"], "bias": np.zeros(3, np.float32)}
        with pytest.raises(ValueError, match="state_proj/bias"):
            convert.from_jax_params(tree, cfgs[1], device="cpu")


class TestTowers:
    def test_siglip_encode(self, cfgs, jparams, tparams, batch):
        images = batch["images"][:, 0]
        ref = jsiglip.encode(jparams["siglip"], jnp.asarray(images), cfgs[0].vision, J32)
        out = tsiglip.encode(tparams["siglip"], torch.from_numpy(images), cfgs[1].vision, T32)
        close(out, ref)

    def test_patchify_equals_conv(self, cfgs, tparams, batch):
        """The reshape patchify is a stride-P VALID convolution with the
        kernel [P, P, 3, D] permuted to [D, 3, P, P]."""
        cfg = cfgs[1].vision
        p = tparams["siglip"]["patch_embed"]
        x = torch.from_numpy(batch["images"][:, 0])
        g, ps = cfg.grid, cfg.patch_size
        patches = x.reshape(-1, g, ps, g, ps, 3).permute(0, 1, 3, 2, 4, 5).reshape(-1, g * g, ps * ps * 3)
        mm = patches @ p["kernel"].reshape(-1, cfg.width) + p["bias"]
        conv = torch.nn.functional.conv2d(
            x.permute(0, 3, 1, 2), p["kernel"].permute(3, 2, 0, 1), p["bias"], stride=ps)
        close(mm, conv.flatten(2).transpose(1, 2), 1e-5)

    @pytest.mark.parametrize("kv_only", [False, True])
    @pytest.mark.parametrize("impl", ["xla", "pallas"])
    def test_prefill(self, cfgs, jparams, tparams, batch, kv_only, impl):
        (je, jm, jpos, _), (te, tm, tpos, _) = prefix_inputs(cfgs, jparams, tparams, batch)
        jx, (jk, jv) = jgemma.prefill(jparams["vlm"], je, jm, jpos, cfgs[0].vlm, J32, impl, kv_only=kv_only)
        tx, (tk, tv) = tgemma.prefill(tparams["vlm"], te, tm, tpos, cfgs[1].vlm, T32, impl, kv_only=kv_only)
        assert tk.shape == jk.shape  # [L, B, P, KVH, D]
        close(tk, jk)
        close(tv, jv)
        if kv_only:
            assert jx is None and tx is None
        else:
            close(tx, jx)

    def test_decode(self, cfgs, jparams, tparams, batch):
        jc, tc = cfgs
        (je, jm, jpos, jpad), (te, tm, tpos, tpad) = prefix_inputs(cfgs, jparams, tparams, batch)
        _, jkv = jgemma.prefill(jparams["vlm"], je, jm, jpos, jc.vlm, J32, kv_only=True)
        _, tkv = tgemma.prefill(tparams["vlm"], te, tm, tpos, tc.vlm, T32, kv_only=True)
        b, s = batch["state"].shape[0], 1 + jc.chunk_size
        rng = np.random.default_rng(3)
        x_suf = rng.standard_normal((b, s, jc.expert.width), dtype=np.float32)
        suf_att = np.zeros((b, s), np.int32)
        suf_att[:, :2] = 1
        suf_self = np.asarray(j_masks(jnp.ones((b, s), bool), jnp.asarray(suf_att)))
        mask = np.concatenate([np.repeat(np.asarray(jpad)[:, None, :], s, 1), suf_self], axis=2)
        pos = np.asarray(jpad).sum(1, keepdims=True).astype(np.int32) + np.arange(s, dtype=np.int32)
        ref = jgemma.decode(jparams["expert"], jkv, jnp.asarray(x_suf), jnp.asarray(mask),
                            jnp.asarray(pos), jc.expert, J32)
        out = tgemma.decode(tparams["expert"], tkv, torch.from_numpy(x_suf), torch.from_numpy(mask),
                            torch.from_numpy(pos), tc.expert, T32)
        close(out, ref)


class TestSampleActions:
    @pytest.mark.parametrize("impl", ["pallas", "xla"])
    def test_matches_jax(self, cfgs, jparams, tparams, batch, impl):
        jc, tc = (dataclasses.replace(c, attention_impl=impl) for c in cfgs)
        keys = ("images", "img_masks", "lang_tokens", "lang_masks", "state")
        ref = jpi0.sample_actions(jparams, None, *(jnp.asarray(batch[k]) for k in keys), jc, J32,
                                  noise=jnp.asarray(batch["noise"]))
        out = tpi0.sample_actions(tparams, None, *(torch.from_numpy(batch[k]) for k in keys), tc, T32,
                                  noise=torch.from_numpy(batch["noise"]))
        assert out.shape == (2, tc.chunk_size, tc.max_action_dim) and out.dtype == torch.float32
        close(out, ref)

    def test_generator_noise_is_seeded(self, cfgs, tparams, batch):
        keys = ("images", "img_masks", "lang_tokens", "lang_masks", "state")
        args = [torch.from_numpy(batch[k]) for k in keys]

        def run(seed):
            return tpi0.sample_actions(tparams, torch.Generator().manual_seed(seed), *args, cfgs[1], T32)

        a1, a2, a3 = run(3), run(3), run(4)
        assert torch.isfinite(a1).all()
        torch.testing.assert_close(a1, a2, rtol=0, atol=0)
        assert not torch.allclose(a1, a3)

    def test_bf16_serving_policy_runs(self, cfgs, tparams, batch):
        keys = ("images", "img_masks", "lang_tokens", "lang_masks", "state")
        params16 = tcm.tree_map(lambda x: x.to(torch.bfloat16), tparams)
        out = tpi0.sample_actions(params16, None, *(torch.from_numpy(batch[k]) for k in keys), cfgs[1],
                                  tcm.SERVING_POLICY, noise=torch.from_numpy(batch["noise"]))
        ref = tpi0.sample_actions(tparams, None, *(torch.from_numpy(batch[k]) for k in keys), cfgs[1],
                                  T32, noise=torch.from_numpy(batch["noise"]))
        assert out.dtype == torch.float32 and torch.isfinite(out).all()
        # bf16 rounding through 2+2 layers and 3 Euler steps
        assert ((out - ref).norm() / ref.norm()).item() < 0.05
