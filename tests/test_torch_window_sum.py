"""Port parity of the windowed-sum kernel K3 and its micro-benchmark.

The plain version (what CPU tensors take) is held against the TPU kernel
itself, the JAX tool's ``consume`` (tools/bench_decouple.py:40-58) run by
``pl.pallas_call(..., interpret=True)``; each of the port tool's six
variants is held against a JAX restatement of the tool's program
(:30-75) in float32 at 32². Tolerances: the window sum in float32 to 1e-6
relative of sum |x| (sums in another order); the variants to 1e-5
relative of the JAX value (the JAX program's convolutions sum in another
order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from deepemia_tpu_torch.kernels.window_sum import WINDOW, window_sum, window_sum_plain
from deepemia_tpu_torch.tools import bench_decouple

torch.set_num_threads(2)


def _pallas_consume(feat):
    """The tool's Pallas kernel, in interpret mode."""
    c = feat.shape[-1]

    def consume_kernel(in_ref, out_ref, scratch, sem):
        cp = pltpu.make_async_copy(in_ref.at[pl.ds(0, 8), pl.ds(0, 16), slice(None)], scratch, sem)
        cp.start()
        cp.wait()
        out_ref[0, 0] = jnp.sum(scratch[...].astype(jnp.float32))

    return pl.pallas_call(
        consume_kernel,
        out_shape=jax.ShapeDtypeStruct((1, 1), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.SMEM),
        scratch_shapes=[pltpu.VMEM((8, 16, c), feat.dtype), pltpu.SemaphoreType.DMA],
        interpret=True,
    )(feat)


@pytest.mark.parametrize("shape", [(256, 256, 256), (20, 33, 8)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_window_sum_matches_pallas_kernel(shape, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    ref = np.asarray(_pallas_consume(jx))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = window_sum(tx)
    assert got.shape == (1, 1) and got.dtype == torch.float32
    assert torch.equal(got, window_sum_plain(tx))
    scale = float(np.abs(np.asarray(jx.astype(jnp.float32))[: WINDOW[0], : WINDOW[1]]).sum())
    assert abs(float(got) - float(ref[0, 0])) <= 1e-6 * scale


def test_window_sum_rejects_other_devices():
    with pytest.raises(ValueError, match="no kernel for device meta"):
        window_sum(torch.empty((8, 16, 4), device="meta"))


def _jax_tool(size, channels, steps):
    """tools/bench_decouple.py:22-75 in float32, ``consume`` restated as the
    window sum it computes; -> {variant: accumulated value}."""
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal((size, size, 3)).astype(np.float32))
    k1 = jnp.asarray(rng.standard_normal((3, 3, 3, channels)) * 0.1, jnp.float32)
    k2 = jnp.asarray(rng.standard_normal((3, 3, channels, channels)) * 0.06, jnp.float32)
    eye = jnp.eye(channels, dtype=jnp.float32)

    def convs(img):
        dn = ("NHWC", "HWIO", "NHWC")
        y = jax.lax.conv_general_dilated(img[None], k1, (1, 1), "SAME", dimension_numbers=dn)
        for _ in range(4):
            y = jax.lax.conv_general_dilated(y, k2, (1, 1), "SAME", dimension_numbers=dn)
        return y[0]

    def consume(f):
        return jnp.sum(f[0:8, 0:16, :].astype(jnp.float32)).reshape(1, 1)

    variants = {
        "no_consumer": lambda f: f.sum().astype(jnp.float32),
        "direct": lambda f: consume(f)[0, 0] + f.sum().astype(jnp.float32),
        "f32_convert": lambda f: consume(f.astype(jnp.float32))[0, 0] + f.sum().astype(jnp.float32),
        "identity_dot": lambda f: consume(
            jax.lax.dot_general(f, eye, (((2,), (0,)), ((), ())), preferred_element_type=jnp.float32)
        )[0, 0] + f.sum().astype(jnp.float32),
        "flip": lambda f: consume(jnp.flip(f, axis=0))[0, 0] + f.sum().astype(jnp.float32),
        "transpose": lambda f: consume(jnp.transpose(f, (1, 0, 2)))[0, 0] + f.sum().astype(jnp.float32),
    }
    out = {}
    for name, post in variants.items():
        acc = jnp.float32(0)
        for i in range(steps):
            acc = acc + post(convs(x + jnp.float32(i)))
        out[name] = float(acc)
    return out


def test_tool_variants_match_jax_restatement():
    size, channels, steps = 32, 16, 8
    ref = _jax_tool(size, channels, steps)
    got = bench_decouple.main(
        device="cpu", size=size, channels=channels, dtype=torch.float32, warmup=0, reps=1, steps=steps
    )
    assert list(got) == list(ref) == [
        "no_consumer", "direct", "f32_convert", "identity_dot", "flip", "transpose"
    ]
    for name, r in ref.items():
        assert got[name]["ms"] > 0
        assert abs(got[name]["value"] - r) <= 1e-5 * abs(r), (name, got[name]["value"], r)
    # the flip reads other rows than the direct window
    assert got["flip"]["value"] != got["direct"]["value"]
