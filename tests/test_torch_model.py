"""Network of the PyTorch port vs the Flax modules of the JAX package.

R18, 64x128 input, fp32 on both sides, the same variables on both sides:
Flax initialises, numpy (seeded) then replaces every batch-norm scale, bias,
mean and variance and every conv bias by non-trivial values, and
``from_flax`` carries the lot across. Tolerance 1e-4 absolute on activations
of order 1 (fp32 convolutions summed in another order by the two libraries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_retina_tpu.models import SphRetinaNet as FlaxRetinaNet
from sph_retina_tpu.models.fpn import FPN as FlaxFPN
from sph_retina_tpu.models.heads.retina_head import SphRetinaHead as FlaxHead
from sph_retina_tpu.models.resnet import Bottleneck as FlaxBottleneck
from sph_retina_tpu.models.resnet import ResNet as FlaxResNet
from sph_retina_tpu_torch.models.from_flax import from_flax, load_flax_variables
from sph_retina_tpu_torch.models.resnet import Bottleneck
from sph_retina_tpu_torch.models.single_stage import SphRetinaNet

NUM_CLASSES, BOX_VERSION, H, W = 3, 5, 64, 128
ATOL = 1e-4


def randomize(tree, rng):
    """Seeded numpy values in place of the trivial initial ones (BN identity,
    zero biases), so that a swapped or dropped leaf shows."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng)
        elif k == "kernel":
            out[k] = np.asarray(v)
        elif k in ("scale", "var"):
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
        else:  # bias, mean
            out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def both():
    """(flax variables as numpy trees, torch model, image, flax outputs)."""
    flax_model = FlaxRetinaNet(num_classes=NUM_CLASSES,
                               box_version=BOX_VERSION, depth=18,
                               dtype=jnp.float32)
    variables = flax_model.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, H, W, 3)))
    rng = np.random.default_rng(0)
    params = randomize(jax.device_get(variables["params"]), rng)
    stats = randomize(jax.device_get(variables["batch_stats"]), rng)
    images = rng.normal(0, 1, (2, H, W, 3)).astype(np.float32)

    @jax.jit
    def staged(params, stats, x):
        feats = FlaxResNet(depth=18, dtype=jnp.float32).apply(
            {"params": params["backbone"], "batch_stats": stats["backbone"]},
            x)
        outs = FlaxFPN(dtype=jnp.float32).apply(
            {"params": params["neck"]}, feats)
        cls, reg = FlaxHead(num_classes=NUM_CLASSES, box_version=BOX_VERSION,
                            dtype=jnp.float32).apply(
            {"params": params["bbox_head"]}, outs)
        whole = flax_model.apply({"params": params, "batch_stats": stats}, x)
        return feats, outs, cls, reg, whole

    ref = jax.device_get(staged(params, stats, jnp.asarray(images)))

    model = SphRetinaNet(num_classes=NUM_CLASSES, box_version=BOX_VERSION,
                         depth=18, dtype=torch.float32).eval()
    load_flax_variables(model, params, stats)
    return params, stats, model, images, ref


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def test_from_flax_round_trip(both):
    """Every leaf arrives, under its module path, transposed back it equals
    the source; nothing of the model's state_dict is left uncovered."""
    params, stats, model, _, _ = both
    state = from_flax(params, stats)
    assert set(state) == set(model.state_dict())

    n_leaves = 0

    def check(tree, path):
        nonlocal n_leaves
        for k, v in tree.items():
            if isinstance(v, dict):
                check(v, path + [k])
                continue
            n_leaves += 1
            name = {"kernel": "weight", "scale": "weight", "bias": "bias",
                    "mean": "running_mean", "var": "running_var"}[k]
            got = state[".".join(path + [name])].numpy()
            if k == "kernel":
                got = got.transpose(2, 3, 1, 0)  # OIHW -> HWIO
            np.testing.assert_array_equal(got, v)

    check(params, [])
    check(stats, [])
    assert n_leaves == len(state)
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_backbone_fpn_head_match_flax(both):
    _, _, model, images, (feats, outs, cls, reg, _) = both
    with torch.no_grad():
        x = torch.from_numpy(images).permute(0, 3, 1, 2)
        t_feats = model.backbone(x)
        # the neck and the head get the FLAX inputs, so each stage is held
        # to its tolerance on its own
        t_outs = model.neck(tuple(
            torch.from_numpy(f).permute(0, 3, 1, 2) for f in feats))
        t_cls, t_reg = model.bbox_head(tuple(
            torch.from_numpy(o).permute(0, 3, 1, 2) for o in outs))
    assert len(t_feats) == 4 and len(t_outs) == 5
    for got, want in zip(t_feats, feats):
        np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=1e-4)
    for got, want in zip(t_outs, outs):
        np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=1e-4)
    for got, want in zip(t_cls + t_reg, list(cls) + list(reg)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=1e-4)


def test_whole_network_matches_flax(both):
    _, _, model, images, (_, _, _, _, (cls, reg)) = both
    with torch.no_grad():
        t_cls, t_reg = model(torch.from_numpy(images))
    sizes = [(8, 16), (4, 8), (2, 4), (1, 2), (1, 1)]
    for lvl, (h, w) in enumerate(sizes):
        assert tuple(t_cls[lvl].shape) == (2, h * w * 9, NUM_CLASSES)
        assert tuple(t_reg[lvl].shape) == (2, h * w * 9, BOX_VERSION)
        np.testing.assert_allclose(t_cls[lvl].numpy(), cls[lvl], atol=ATOL,
                                   rtol=1e-4)
        np.testing.assert_allclose(t_reg[lvl].numpy(), reg[lvl], atol=ATOL,
                                   rtol=1e-4)


def test_resnext_bottleneck_block_matches_flax():
    """groups=4, base_width=8 with stride 2 and a downsample branch: the
    grouped 3x3 kernel keeps I = in/groups in both layouts."""
    rng = np.random.default_rng(1)
    fb = FlaxBottleneck(planes=16, stride=2, downsample=True,
                        dtype=jnp.float32, groups=4, base_width=8)
    x = rng.normal(0, 1, (2, 8, 12, 32)).astype(np.float32)
    variables = fb.init(jax.random.PRNGKey(1), jnp.asarray(x))
    params = randomize(jax.device_get(variables["params"]), rng)
    stats = randomize(jax.device_get(variables["batch_stats"]), rng)
    want = np.asarray(fb.apply({"params": params, "batch_stats": stats},
                               jnp.asarray(x)))

    tb = Bottleneck(32, 16, stride=2, downsample=True, groups=4,
                    base_width=8).eval()
    assert tb.conv2.weight.shape == (8, 2, 3, 3)
    load_flax_variables(tb, params, stats)
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(_nhwc(got), want, atol=ATOL, rtol=1e-4)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_load_fails_loudly(both, fault):
    params, stats, model, _, _ = both
    params = {k: dict(v) for k, v in params.items()}
    if fault == "missing":
        del params["neck"]["lateral_0"]
        err = KeyError
    elif fault == "extra":
        params["neck"]["lateral_9"] = params["neck"]["lateral_0"]
        err = KeyError
    else:
        lat = dict(params["neck"]["lateral_0"])
        lat["kernel"] = lat["kernel"][..., :-1]
        params["neck"]["lateral_0"] = lat
        err = ValueError
    with pytest.raises(err, match="lateral"):
        load_flax_variables(model, params, stats)


def test_init_weights_is_seeded_and_keeps_the_focal_prior():
    a = SphRetinaNet(num_classes=2, depth=18, dtype=torch.float32)
    b = SphRetinaNet(num_classes=2, depth=18, dtype=torch.float32)
    a.init_weights(torch.Generator().manual_seed(3))
    b.init_weights(torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert torch.allclose(a.bbox_head.retina_cls.bias,
                          torch.tensor(-np.log(99.0), dtype=torch.float32))
    assert float(a.backbone.bn1.running_var.min()) == 1.0
