"""The port's vision tower and video front end vs the JAX package on the
CPU: the host-side index functions (bit-equal, over ragged windows, an odd
frame count, two samples and a padded merged count), the tower in f32 on
the same weights (through the bridge) with float and int8 weights, the
video front end (`video_to_patches` bit-equal, `smart_resize`,
`frame_process` and `extract_frames` on an MJPG file the test writes), the
OpenCV message where cv2 is missing, `convert_vision_state_dict` on a
synthetic HF-named state dict, `get_rope_index` and `compute_mrope` at
positions whose t, h and w rows differ."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unimoe_audio_tpu.apps import video as JVID
from unimoe_audio_tpu.config import VisionConfig as JVisionConfig
from unimoe_audio_tpu.config import tiny_test_config as j_tiny_test_config
from unimoe_audio_tpu.core import convert as JCONV
from unimoe_audio_tpu.models import layers as JL
from unimoe_audio_tpu.models import model as JM
from unimoe_audio_tpu.models import vision as JV
from unimoe_audio_tpu.ops import quant as JQ
from unimoe_audio_torch.apps import video as TVID
from unimoe_audio_torch.config import VisionConfig, tiny_test_config
from unimoe_audio_torch.core import convert as TCONV
from unimoe_audio_torch.core.bridge import to_torch
from unimoe_audio_torch.models import layers as TL
from unimoe_audio_torch.models import model as TM
from unimoe_audio_torch.models import vision as TV
from unimoe_audio_torch.ops import quant as TQ
from tests.torch_threads import one_torch_thread  # noqa: F401

# The JAX package's `tests/test_vision.py` small tower: depth 3, block 1 full
# attention, windows of 2 x 2 merged patches.
SMALL = dict(depth=3, hidden_size=32, intermediate_size=64, num_heads=4, patch_size=2,
             temporal_patch_size=2, spatial_merge_size=2, out_hidden_size=48, window_size=8,
             fullatt_block_indexes=(1,))

# Ragged windows (6 x 10 patches merge to 3 x 5, windows of 2 x 2), an odd
# temporal grid, two samples, a single window.
GRIDS = [[[1, 6, 10]], [[3, 4, 8]], [[1, 4, 4], [2, 6, 4]], [[1, 2, 2]]]

TOWER_RTOL, TOWER_ATOL = 1e-5, 1e-6


def _jax_tower(jp, patches, g, jc):
    """JAX's `vision_forward`, op by op (jit off), as the port runs: under
    jit XLA fuses the elementwise ops and skips roundings between them (in
    the int8 path, whose patch embed and first projections are bf16, that
    alone moves the output by 2.5e-3 relative), so the jitted tower is not
    the same sequence of f32 / bf16 operations."""
    with jax.disable_jit():
        return np.asarray(JV.vision_forward(jp, jnp.asarray(patches), g, jc))


def _cfgs():
    return VisionConfig(**SMALL), JVisionConfig(**SMALL)


def test_tiny_config_with_vision_equals_jax():
    """`tiny_test_config(with_vision=True)` field for field, the vision
    config's included."""
    import dataclasses

    t, j = tiny_test_config(with_vision=True), j_tiny_test_config(with_vision=True)
    assert t.to_dict() == j.to_dict()
    assert dataclasses.asdict(t.vision_config) == dataclasses.asdict(j.vision_config)
    assert t.vision_config.head_dim == j.vision_config.head_dim


@pytest.mark.parametrize("grid", GRIDS, ids=["ragged", "odd_t", "two_samples", "one_window"])
def test_index_functions_equal_jax(grid):
    tc, jc = _cfgs()
    g = np.asarray(grid)
    np.testing.assert_array_equal(TV.rot_pos_ids(g, 2), JV.rot_pos_ids(g, 2))
    for a, b in zip(TV.window_index(g, tc), JV.window_index(g, jc)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(TV.sample_ids(g), JV.sample_ids(g))
    np.testing.assert_array_equal(TV.sample_ids_merged(g, 2), JV.sample_ids_merged(g, 2))
    n_merged = int(sum(t * (h // 2) * (w // 2) for t, h, w in grid))
    for pad in (0, n_merged + 3):
        got, want = TV.vision_indices(g, tc, pad), JV.vision_indices(g, jc, pad)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            if k != "n_merged":
                assert got[k].dtype == want[k].dtype, k


def _tower_inputs(grid, seed):
    tc, jc = _cfgs()
    jp = JV.init_vision_params(jax.random.PRNGKey(seed), jc, dtype=jnp.float32)
    # Non-trivial norms and biases, so that every weight matters.
    rng = np.random.default_rng(seed)
    jp = jax.tree.map(lambda a: a + 0.1 * rng.standard_normal(a.shape).astype(np.float32)
                      if a.ndim == 1 else a, jp)
    g = np.asarray(grid)
    S = int(sum(t * h * w for t, h, w in grid))
    patches = rng.standard_normal((S, 3 * 2 * 2 * 2)).astype(np.float32)
    return tc, jc, jp, g, patches


@pytest.mark.parametrize("grid", GRIDS[:3], ids=["ragged", "odd_t", "two_samples"])
def test_vision_forward_equals_jax(grid):
    tc, jc, jp, g, patches = _tower_inputs(grid, seed=len(grid[0]) + grid[0][0])
    want = _jax_tower(jp, patches, g, jc)
    tp = to_torch(jax.tree.map(np.asarray, jp), "cpu", None)
    got = TV.vision_forward(tp, torch.tensor(patches), g, tc)
    n_merged = int(sum(t * (h // 2) * (w // 2) for t, h, w in grid))
    assert got.shape == want.shape == (n_merged, SMALL["out_hidden_size"])
    np.testing.assert_allclose(got.numpy(), want, rtol=TOWER_RTOL, atol=TOWER_ATOL)


def test_vision_forward_int8_equals_jax():
    """`quantize_vision_params`: every q and s bit-equal to JAX's; the tower
    on them within 1e-5 relative L2 of JAX's (f32 weights and biases; the
    patch embed takes bf16 patches, as in JAX)."""
    tc, jc, jp, g, patches = _tower_inputs(GRIDS[2], seed=4)
    jq = JQ.quantize_vision_params(jp)
    tq = TQ.quantize_vision_params(to_torch(jax.tree.map(np.asarray, jp), "cpu", None))
    pairs = [(tq["patch_embed"], jq["patch_embed"])]
    for tb, jb in zip(tq["blocks"], jq["blocks"]):
        pairs += [(tb["qkv"]["w"], jb["qkv"]["w"]), (tb["proj"]["w"], jb["proj"]["w"])]
        pairs += [(tb["mlp"][k]["w"], jb["mlp"][k]["w"]) for k in ("gate", "up", "down")]
        np.testing.assert_array_equal(tb["qkv"]["b"].numpy(), np.asarray(jb["qkv"]["b"]))
    pairs += [(tq["merger"][k]["w"], jq["merger"][k]["w"]) for k in ("fc1", "fc2")]
    for t, j in pairs:
        assert isinstance(t, TQ.QTensor) and t.q.dtype == torch.int8
        np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
        np.testing.assert_array_equal(t.s.numpy(), np.asarray(j.s))
    want = _jax_tower(jq, patches, g, jc)
    got = TV.vision_forward(to_torch(jax.tree.map(np.asarray, jq), "cpu", None),
                            torch.tensor(patches), g, tc).float().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-5


def test_masks_built_once_per_tower_call(monkeypatch):
    """The [S, S] window and full masks are made once per tower call and
    shared by the blocks."""
    tc, _, jp, g, patches = _tower_inputs(GRIDS[0], seed=1)
    seen = []
    block = TV.vision_block
    monkeypatch.setattr(TV, "vision_block",
                        lambda p, x, cos, sin, mask, cfg: seen.append(mask) or
                        block(p, x, cos, sin, mask, cfg))
    TV.vision_forward(to_torch(jax.tree.map(np.asarray, jp), "cpu", None),
                      torch.tensor(patches), g, tc)
    assert len(seen) == 3 and seen[0] is seen[2] and seen[1] is not seen[0]


@pytest.mark.parametrize("T,H,W", [(2, 28, 28), (1, 28, 56), (3, 56, 28), (4, 56, 84)])
def test_video_to_patches_bit_equal(T, H, W):
    video = np.random.default_rng(T).uniform(0, 255, size=(T, 3, H, W)).astype(np.float32)
    got, ggrid = TVID.video_to_patches(video)
    want, wgrid = JVID.video_to_patches(video)
    np.testing.assert_array_equal(ggrid, wgrid)
    assert got.dtype == want.dtype and ggrid.dtype == wgrid.dtype
    np.testing.assert_array_equal(got, want)


def test_smart_resize_equals_jax():
    for h in (1, 20, 27, 28, 100, 224, 481, 720, 1080, 3000):
        for w in (1, 29, 56, 300, 1280, 1920):
            for kw in ({}, {"min_pixels": 28 * 28, "max_pixels": TVID.VIDEO_MAX_PIXELS},
                       {"min_pixels": 16 * 28 * 28, "max_pixels": 2 * 28 * 28}):
                assert TVID.smart_resize(h, w, **kw) == JVID.smart_resize(h, w, **kw), (h, w, kw)
    for name in ("IMAGE_FACTOR", "VIDEO_TOTAL_PIXELS", "VIDEO_MIN_PIXELS", "VIDEO_MAX_PIXELS",
                 "FRAME_FACTOR"):
        assert getattr(TVID, name) == getattr(JVID, name)
    np.testing.assert_array_equal(TVID.CLIP_MEAN, JVID.CLIP_MEAN)
    np.testing.assert_array_equal(TVID.CLIP_STD, JVID.CLIP_STD)


def write_avi(path, n_frames=6, size=(64, 48), fps=4, seed=0):
    """A small MJPG .avi of random frames; returns the path."""
    cv2 = pytest.importorskip("cv2")
    w, h = size
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), fps, (w, h))
    assert out.isOpened()
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        out.write(rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8))
    out.release()
    return str(path)


def test_extract_frames_and_frame_process_equal_jax(tmp_path):
    path = write_avi(tmp_path / "clip.avi")
    for fps, max_frames in ((1, None), (2, 3), (4, 1)):
        got = TVID.extract_frames(path, fps, max_frames)
        want = JVID.extract_frames(path, fps, max_frames)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    frames = TVID.extract_frames(path, 2, None)
    for kw in ({}, {"total_pixels": 3 * 28 * 28, "min_pixels": 28 * 28},
               {"resized_height": 60, "resized_width": 90}, {"max_pixels": 28 * 28}):
        got, want = TVID.frame_process(frames, **kw), JVID.frame_process(frames, **kw)
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        TVID.extract_frames(str(tmp_path / "none.avi"), 1)


def test_video_file_without_opencv_names_the_way_round(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    for call in (lambda: TVID.extract_frames("clip.mp4", 1),
                 lambda: TVID.frame_process([np.zeros((28, 28, 3), np.uint8)])):
        with pytest.raises(ImportError, match=r"cv2.*pre-extracted frames"):
            call()
    # The array route needs no OpenCV.
    flat, grid = TVID.video_to_patches(np.zeros((2, 3, 28, 28), np.float32))
    assert list(grid) == [1, 2, 2] and flat.shape == (4, 1176)


def _hf_visual_sd(vc, seed, with_bias=True):
    rng = np.random.default_rng(seed)
    D, Fd, m2 = vc.hidden_size, vc.intermediate_size, vc.spatial_merge_size ** 2

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    sd = {"visual.patch_embed.proj.weight": r(D, vc.in_channels, vc.temporal_patch_size,
                                              vc.patch_size, vc.patch_size),
          "visual.merger.ln_q.weight": r(D),
          "visual.merger.mlp.0.weight": r(D * m2, D * m2), "visual.merger.mlp.0.bias": r(D * m2),
          "visual.merger.mlp.2.weight": r(vc.out_hidden_size, D * m2),
          "visual.merger.mlp.2.bias": r(vc.out_hidden_size)}
    for i in range(vc.depth):
        b = f"visual.blocks.{i}"
        sd.update({f"{b}.norm1.weight": r(D), f"{b}.norm2.weight": r(D),
                   f"{b}.attn.qkv.weight": r(3 * D, D), f"{b}.attn.proj.weight": r(D, D),
                   f"{b}.mlp.gate_proj.weight": r(Fd, D), f"{b}.mlp.up_proj.weight": r(Fd, D),
                   f"{b}.mlp.down_proj.weight": r(D, Fd)})
        if with_bias:
            sd.update({f"{b}.attn.qkv.bias": r(3 * D), f"{b}.attn.proj.bias": r(D),
                       f"{b}.mlp.gate_proj.bias": r(Fd), f"{b}.mlp.up_proj.bias": r(Fd),
                       f"{b}.mlp.down_proj.bias": r(D)})
    return sd


def _assert_trees_equal(a, b, path=""):
    if isinstance(b, dict):
        assert a.keys() == b.keys(), path
        for k in b:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}[{i}]")
    else:
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("with_bias", [True, False])
def test_convert_vision_state_dict_equals_jax(with_bias):
    """A synthetic HF-named `visual.*` state dict (torch tensors for the
    port, numpy for JAX): equal trees; the patch embed's conv3d flattened
    to [C·tps·ps·ps, D] makes the same features as the conv3d itself."""
    tc, jc = _cfgs()
    sd = _hf_visual_sd(tc, seed=int(with_bias), with_bias=with_bias)
    got = TCONV.convert_vision_state_dict({k: torch.tensor(v) for k, v in sd.items()}, tc)
    _assert_trees_equal(got, JCONV.convert_vision_state_dict(sd, jc))
    video = np.random.default_rng(2).uniform(0, 255, (2, 3, 4, 8)).astype(np.float32)
    patches, grid = TVID.video_to_patches(video, patch_size=2)
    conv = torch.nn.functional.conv3d(
        torch.tensor(patches).reshape(-1, 3, 2, 2, 2),
        torch.tensor(sd["visual.patch_embed.proj.weight"]), stride=2).reshape(len(patches), -1)
    np.testing.assert_allclose(patches @ got["patch_embed"], conv.numpy(), rtol=1e-5, atol=1e-4)


def _vision_ids(cfg, spans, T, pads, seed):
    """Rows of left pads, text, then for each (kind, n_tokens) a span
    <vision_start> n x token <vision_end>, and text after."""
    rng = np.random.default_rng(seed)
    rows = []
    for pad, row_spans in zip(pads, spans):
        toks = list(rng.integers(5, 40, size=3))
        for kind, n in row_spans:
            tok = cfg.image_token_id if kind == "image" else cfg.video_token_id
            toks += [cfg.vision_start_token_id] + [tok] * n + [cfg.vision_end_token_id]
            toks += list(rng.integers(5, 40, size=2))
        toks = [0] * pad + toks
        rows.append(toks + [7] * (T - len(toks)))
    ids = np.asarray(rows, np.int64)
    mask = np.ones_like(ids)
    for r, pad in enumerate(pads):
        mask[r, :pad] = 0
    return ids, mask


def test_get_rope_index_equals_jax():
    """Image and video spans, second_per_grid_ts, left pads, two rows; and
    the text-only forms with and without a mask."""
    tcfg, jcfg = tiny_test_config(with_vision=True), j_tiny_test_config(with_vision=True)
    # Row 0: an image (1 x 4 x 4 → 4 tokens) then a video (2 x 4 x 8 → 16);
    # row 1: a video (3 x 4 x 4 → 12), left-padded by 5.
    ids, mask = _vision_ids(tcfg, [[("image", 4), ("video", 16)], [("video", 12)]], 48, (0, 5), 0)
    kw = dict(image_grid_thw=np.array([[1, 4, 4]]), video_grid_thw=np.array([[2, 4, 8], [3, 4, 4]]),
              second_per_grid_ts=[0.5, 2.0], attention_mask=mask)
    got, want = TM.get_rope_index(ids, tcfg, **kw), JM.get_rope_index(ids, jcfg, **kw)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    assert not np.array_equal(got[0][0], got[0][1]) and (got[1] < 0).all()
    for kw in ({"video_grid_thw": np.array([[2, 4, 8], [3, 4, 4]])},):
        ids2, _ = _vision_ids(tcfg, [[("video", 16)], [("video", 12)]], 40, (0, 0), 1)
        for a, b in zip(TM.get_rope_index(ids2, tcfg, **kw), JM.get_rope_index(ids2, jcfg, **kw)):
            np.testing.assert_array_equal(a, b)
    for m in (mask, None):
        for a, b in zip(TM.get_rope_index(ids, tcfg, attention_mask=m),
                        JM.get_rope_index(ids, jcfg, attention_mask=m)):
            np.testing.assert_array_equal(a, b)


def test_compute_mrope_equals_jax_for_distinct_rows():
    cfg = tiny_test_config(with_vision=True)
    tc = cfg.text_config
    ids, mask = _vision_ids(cfg, [[("video", 16)], [("video", 8)]], 40, (0, 3), 2)
    pos, _ = TM.get_rope_index(ids, cfg, video_grid_thw=np.array([[2, 4, 8], [1, 4, 8]]),
                               attention_mask=mask)
    assert not np.array_equal(pos[1], pos[2])
    jcos, jsin = JL.compute_mrope(jnp.asarray(pos), tc.head_dim, tc.rope_theta,
                                  tc.mrope_section)
    tcos, tsin = TL.compute_mrope(torch.tensor(pos), tc.head_dim, tc.rope_theta,
                                  tc.mrope_section)
    np.testing.assert_allclose(tcos.numpy(), np.asarray(jcos), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(jsin), rtol=1e-6, atol=1e-6)
