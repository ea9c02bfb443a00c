"""The port's LPIPS (``ops/lpips.py``) against the JAX package's.

Pretrained VGG weights are not in this repository, so both sides get the
same seeded random weights in the ``.npz`` layout of the JAX package's
``scripts/export_lpips_weights.py`` (``tests/test_metrics.py``'s
``_random_weights``). Bound: 1e-5 relative, and LPIPS(x, x) = 0 exactly;
measured ~3e-6 (a 13-conv f32 stack summed in another order by each
framework's CPU convolution).
"""

import numpy as np
import pytest
import torch

from gaussian_splatting_lightning_tpu.ops import lpips as jlpips
from gaussian_splatting_lightning_tpu_torch.ops import lpips as tlpips
from tests.test_metrics import _random_weights


@pytest.fixture(scope="module")
def weights():
    return _random_weights(np.random.default_rng(0))


def pair(rng, shape, noise=0.2):
    img = rng.uniform(size=shape).astype(np.float32)
    other = np.clip(img + rng.normal(0, noise, img.shape), 0, 1).astype(np.float32)
    return img, other


@pytest.mark.parametrize("shape", [(3, 48, 64), (3, 37, 50), (2, 3, 40, 56)],
                         ids=["single", "single-odd", "batched"])
def test_lpips_matches_jax(weights, shape):
    img, other = pair(np.random.default_rng(1), shape)
    want = np.asarray(jlpips.lpips(img, other, weights))
    got = tlpips.lpips(torch.from_numpy(img), torch.from_numpy(other), weights)
    assert tuple(got.shape) == want.shape == shape[:-3]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=0)
    same = tlpips.lpips(torch.from_numpy(img), torch.from_numpy(img), weights)
    assert not bool(same.any())


def test_lpips_takes_tensor_weights_and_grows_with_noise(weights):
    rng = np.random.default_rng(2)
    img, small = pair(rng, (3, 32, 32), 0.02)
    _, large = pair(np.random.default_rng(2), (3, 32, 32), 0.3)
    tw = {k: torch.from_numpy(v) for k, v in weights.items()}
    a = tlpips.lpips(torch.from_numpy(img), torch.from_numpy(small), tw)
    b = tlpips.lpips(torch.from_numpy(img), torch.from_numpy(large), weights)
    assert 0.0 < float(a) < float(b)


def test_load_weights_errors_match_jax(tmp_path, weights):
    good = tmp_path / "good.npz"
    np.savez(good, **weights)
    assert set(tlpips.load_weights(good)) == set(weights)
    cases = {
        "wrong-width": dict(weights, conv3_w=weights["conv3_w"][:7]),
        "missing-conv": {k: v for k, v in weights.items() if k != "conv5_b"},
        "wrong-lin": dict(weights, lin2_w=weights["lin2_w"][:3]),
        "missing-lin": {k: v for k, v in weights.items() if k != "lin4_w"},
    }
    for name, data in cases.items():
        path = tmp_path / f"{name}.npz"
        np.savez(path, **data)
        with pytest.raises(ValueError) as want:
            jlpips.load_weights(path)
        with pytest.raises(ValueError) as got:
            tlpips.load_weights(path)
        assert str(got.value) == str(want.value), name
