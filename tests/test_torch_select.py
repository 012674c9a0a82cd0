"""The describe stage's sample select: cv_tpu_torch's plain version against
cv_tpu's Pallas gather kernel (interpret mode) on patches cut by JAX from
the same plane stack, and the CUDA kernel against the plain version.  A
select is exact, so both comparisons are bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cv_tpu.akaze import pallas_mldb
from cv_tpu_torch.akaze.select import select_samples, select_samples_plain
from torch_threads import one_thread  # noqa: F401  (autouse: this module's torch on one thread)

P = 128


def _inputs(seed, k, ns, levels=5, hp=256, wp=384):
    rng = np.random.default_rng(seed)
    planes = rng.normal(size=(levels, 3, hp, wp)).astype(np.float32)
    lvl = rng.integers(0, levels, k).astype(np.int32)
    y0 = rng.integers(0, hp - P + 1, k).astype(np.int32)
    x0 = rng.integers(0, wp - P + 1, k).astype(np.int32)
    rel_x = rng.integers(0, P, (k, ns)).astype(np.int32)
    rel_y = rng.integers(0, P, (k, ns)).astype(np.int32)
    return planes, lvl, y0, x0, rel_x, rel_y


def _jax_select(planes, lvl, y0, x0, rel_x, rel_y, c0):
    """The reference composition: cut one 3x128x128 patch per keypoint
    (descriptors.orient_mldb_onehot), then the Pallas gather kernel with the
    sample axis padded to a lane multiple."""
    planes = jnp.asarray(planes)

    def slice_one(l, y, x):
        zero = jnp.zeros((), l.dtype)
        return jax.lax.dynamic_slice(planes, (l, zero, y, x), (1, 3, P, P))[0]

    patches = jax.vmap(slice_one)(jnp.asarray(lvl), jnp.asarray(y0), jnp.asarray(x0))
    ns = rel_x.shape[1]
    pad = ((0, 0), (0, (-ns) % P))
    out = pallas_mldb.select_samples_gather(
        patches,
        jnp.asarray(np.pad(rel_x, pad)),
        jnp.asarray(np.pad(rel_y, pad)),
        interpret=True,
        c0=c0,
    )
    return np.asarray(out)[:, :, :ns]


@pytest.mark.parametrize("c0,ns", [(1, 109), (0, 441)])
def test_plain_matches_pallas_gather(c0, ns):
    args = _inputs(seed=ns, k=16, ns=ns)
    ref = _jax_select(*args, c0=c0)
    got = select_samples_plain(*(torch.as_tensor(a) for a in args), c0=c0).numpy()
    assert got.shape == ref.shape == (16, 3 - c0, ns)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("c0", [0, 1])
def test_wrapper_runs_plain_on_cpu(c0):
    args = [torch.as_tensor(a) for a in _inputs(seed=7, k=8, ns=33)]
    before = select_samples.launches
    got = select_samples(*args, c0=c0)
    assert select_samples.launches == before  # no kernel launch on the CPU
    torch.testing.assert_close(got, select_samples_plain(*args, c0=c0), rtol=0, atol=0)


def test_wrapper_rejects_mixed_devices():
    args = [torch.as_tensor(a) for a in _inputs(seed=1, k=4, ns=8)]
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError):
        select_samples(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("c0,ns", [(1, 109), (0, 441)])
def test_cuda_kernel_matches_plain(c0, ns):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the select kernel runs only there")
    args = [torch.as_tensor(a, device="cuda") for a in _inputs(seed=3, k=4096, ns=ns)]
    before = select_samples.launches
    got = select_samples(*args, c0=c0)
    torch.cuda.synchronize()
    assert select_samples.launches == before + 1
    torch.testing.assert_close(got, select_samples_plain(*args, c0=c0), rtol=0, atol=0)
