"""Dense→MoE surgery and the expert-parallel checkpoint tools of the PyTorch
port vs the JAX package on the CPU: `moeify_dense_params` (the copied
dynamic-expert slices at their rotating offsets and the fixed experts
bit-equal to JAX's for moe_copy "all", expert 0 for "single"; the drawn
experts and the fresh f32 router gate by shape, dtype and a std within 10 %
of initializer_range; the input left as it was), the surgered model's
forward, `aggregate_deepspeed_moe_checkpoint` on a torch.save'd synthetic
DeepSpeed directory (equal to JAX's dict, integer dtypes kept, both
shard-consistency asserts), and `split_expert_shards` /
`merge_expert_shards` per rank against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu.config import tiny_test_config
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.train import resharding as JR
from unimoe_audio_tpu.train import surgery as JSU
from unimoe_audio_torch.core.bridge import params_from_jax, params_to_numpy
from unimoe_audio_torch.models import model as TM
from unimoe_audio_torch.train import resharding as TR
from unimoe_audio_torch.train import surgery as TSU


@pytest.fixture(scope="module")
def dense():
    """A tiny dense model in the JAX layout (layers.mlp, F = 256 over
    expert sizes F_d 64, F_s 32) with numpy leaves."""
    cfg = tiny_test_config(dynamic_intermediate_size=64, shared_intermediate_size=32)
    tc = cfg.text_config
    jp = jax.tree.map(np.asarray, JM.init_model_params(jax.random.PRNGKey(0), cfg,
                                                       dtype=jnp.float32))
    L, D, F = tc.num_hidden_layers, tc.hidden_size, tc.intermediate_size
    rng = np.random.default_rng(0)
    layers = {k: v for k, v in jp["layers"].items() if k != "moe"}
    layers["mlp"] = {"gate": rng.normal(size=(L, D, F)).astype(np.float32),
                     "up": rng.normal(size=(L, D, F)).astype(np.float32),
                     "down": rng.normal(size=(L, F, D)).astype(np.float32)}
    return cfg, {**jp, "layers": layers}


def _snapshot(tree):
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_snapshot(v) for v in tree]
    return tree.clone()


def _same_tree(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


@pytest.mark.parametrize("moe_copy", ["all", "single", "none"])
def test_moeify_matches_jax(dense, moe_copy):
    cfg, tree = dense
    tc = cfg.text_config
    Er, Fd = tc.mlp_dynamic_expert_num, tc.dynamic_intermediate_size
    want = jax.tree.map(np.asarray, JSU.moeify_dense_params(tree, tc, moe_copy=moe_copy,
                                                            dtype=jnp.float32))
    tp = params_from_jax(tree, cfg, "cpu")
    before = _snapshot(tp)
    out = TSU.moeify_dense_params(tp, tc, moe_copy=moe_copy, seed=3, dtype=torch.float32)
    assert _same_tree(tp, before) and "moe" not in tp["layers"][0]       # input unchanged
    got = params_to_numpy(out)
    assert set(got["layers"]) == set(want["layers"])
    gm, wm = got["layers"]["moe"], want["layers"]["moe"]
    for k in ("gate", "up", "down"):
        np.testing.assert_array_equal(gm["fixed"][k], wm["fixed"][k])
        copied = {"all": range(Er), "single": [0], "none": []}[moe_copy]
        for e in range(Er):
            g, w = gm["dynamic"][k][:, e], wm["dynamic"][k][:, e]
            assert g.shape == w.shape and g.dtype == w.dtype == np.float32
            if e in copied:
                np.testing.assert_array_equal(g, w)
                off = (e * Fd) % tc.intermediate_size
                src = tree["layers"]["mlp"][k]
                np.testing.assert_array_equal(
                    g, src[:, off:off + Fd, :] if k == "down" else src[:, :, off:off + Fd])
            else:
                assert abs(g.std() / tc.initializer_range - 1) < 0.1 and abs(g.mean()) < 0.01
    assert out["layers"][0]["moe"]["gate"].dtype == torch.float32
    assert gm["gate"].shape == wm["gate"].shape
    assert abs(gm["gate"].std() / tc.initializer_range - 1) < 0.1
    rest = {k: v for k, v in got.items() if k != "layers"}
    for k, v in rest.items():
        np.testing.assert_array_equal(v, want[k])
    # The surgered model runs; bf16 surgery keeps the gate in f32.
    ids = torch.as_tensor(np.random.default_rng(1).integers(0, 200, (2, 8)))
    assert torch.isfinite(TM.model_forward(out, cfg, ids).codec_logits).all()
    bf = TSU.moeify_dense_params(tp, tc, moe_copy=moe_copy)
    assert bf["layers"][1]["moe"]["gate"].dtype == torch.float32
    assert bf["layers"][1]["moe"]["dynamic"]["up"].dtype == torch.bfloat16
    assert bf["embed_tokens"].dtype == torch.bfloat16 and bf["embed_tokens"] is not tp["embed_tokens"]


def _ds_dir(path, malformed=None):
    """A synthetic DeepSpeed MoE checkpoint: the base state (bf16 norm, an
    int64 step counter, a bool mask) and 2 layers x 4 global experts, each
    shard holding local expert 0 (bf16 and f32 leaves)."""
    base = {"language_model.norm.weight": torch.randn(8).to(torch.bfloat16),
            "global_steps": torch.tensor(17, dtype=torch.int64),
            "language_model.mask": torch.tensor([True, False, True])}
    torch.save({"module": base}, path / "mp_rank_00_model_states.pt")
    for l in range(2):
        for e in range(4):
            key = f"language_model.layers.{l}.deepspeed_moe.experts.deepspeed_experts.0."
            shard = {key + "gate_proj.weight": torch.randn(4, 8).to(torch.bfloat16),
                     key + "down_proj.weight": torch.randn(8, 4)}
            if malformed == "layer" and (l, e) == (1, 2):
                shard = {k.replace("layers.1.", "layers.0."): v for k, v in shard.items()}
            if malformed == "duplicate" and (l, e) == (0, 1):
                shard[key.replace("experts.0.", "experts.1.") + "gate_proj.weight"] = \
                    torch.randn(4, 8)
            torch.save(shard, path / f"layer_{l}_expert_{e}_mp_rank_00_model_states.pt")


def test_aggregate_deepspeed_checkpoint_matches_jax(tmp_path):
    _ds_dir(tmp_path)
    got = TR.aggregate_deepspeed_moe_checkpoint(str(tmp_path))
    want = JR.aggregate_deepspeed_moe_checkpoint(str(tmp_path))
    assert set(got) == set(want) and len(got) == 3 + 2 * 4 * 2
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert got["global_steps"].dtype == np.int64 and got["language_model.mask"].dtype == bool
    assert "language_model.layers.1.deepspeed_moe.experts.deepspeed_experts.3.gate_proj.weight" \
        in got


@pytest.mark.parametrize("malformed,match", [("layer", "file layer"), ("duplicate", "duplicate")])
def test_aggregate_asserts_on_malformed_shards(tmp_path, malformed, match):
    _ds_dir(tmp_path, malformed)
    with pytest.raises(AssertionError, match=match):
        TR.aggregate_deepspeed_moe_checkpoint(str(tmp_path))
    with pytest.raises(AssertionError, match=match):
        JR.aggregate_deepspeed_moe_checkpoint(str(tmp_path))


@pytest.mark.parametrize("ep", [1, 2, 4])
def test_split_merge_match_jax(ep):
    """The port's per-layer experts split into ep ranks: each rank's shard,
    its layers stacked, equals JAX's; merging gives the experts back bit for
    bit."""
    rng = np.random.default_rng(0)
    dyn = {"gate": rng.normal(size=(2, 4, 8, 16)).astype(np.float32),
           "up": rng.normal(size=(2, 4, 8, 16)).astype(np.float32),
           "down": rng.normal(size=(2, 4, 16, 8)).astype(np.float32)}
    want = JR.split_expert_shards({"layers": {"moe": {"dynamic": dyn}}}, ep)
    params = {"layers": [{"moe": {"dynamic": {k: torch.tensor(v[l]) for k, v in dyn.items()}}}
                         for l in range(2)]}
    shards = TR.split_expert_shards(params, ep)
    assert len(shards) == len(want) == ep
    for got_r, want_r in zip(shards, want):
        for k in dyn:
            np.testing.assert_array_equal(np.stack([lay[k].numpy() for lay in got_r]), want_r[k])
    back = TR.merge_expert_shards(shards)
    for l in range(2):
        for k in dyn:
            assert torch.equal(back[l][k], params["layers"][l]["moe"]["dynamic"][k])
    with pytest.raises(AssertionError, match="divisible"):
        TR.split_expert_shards(params, 3)
