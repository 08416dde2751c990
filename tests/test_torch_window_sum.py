"""Port parity of the windowed-sum kernel K3 and its micro-benchmark.

The plain version (what CPU tensors take) is held against the TPU kernel
itself, the JAX tool's ``consume`` (tools/bench_decouple.py:40-58) run by
``pl.pallas_call(..., interpret=True)``; each of the port tool's six
variants is held against a JAX restatement of the tool's program
(:30-75) in float32 at 32². The kernel's plan (``window_sum_plan``) is
checked to load every window element once and nothing else, and a sum
taken in the plan's thread, warp, block and cluster order is held
against the plain version and the Pallas kernel. Tolerances: the window
sum in float32 to 1e-6 relative of sum |x| (sums in another order); the
variants to 1e-5 relative of the JAX value (the JAX program's
convolutions sum in another order)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from deepemia_tpu_torch.kernels import window_sum as ws
from deepemia_tpu_torch.kernels.window_sum import WINDOW, window_sum, window_sum_plain, window_sum_plan
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


# the kernel's edge cases on the card (chip_smoke.py phase 10) and more:
# 8x16xC exactly, C in {1, 3, 8, 257}, a row pitch W*C*esize that is not a
# multiple of 16, the benchmark's shape
PLAN_SHAPES = [
    (8, 16, 256), (8, 16, 1), (20, 33, 1), (20, 33, 3), (20, 33, 8), (20, 33, 257),
    (12, 21, 10), (9, 17, 12), (256, 256, 256),
]
ESIZE = {"bfloat16": 2, "float32": 4}


def _plan_loads(plan):
    """The first element (from the operand's base) of every load the kernel
    makes under ``plan``, in kernel order: [blocks] lists of [threads]
    arrays, one per load slot, with -1 where the slot is predicated off."""
    t = np.arange(ws.THREADS)
    per_block = []
    for b in range(plan.blocks):
        slots = []
        for r in range(b, plan.rows, plan.blocks):
            for base in range(0, plan.loads_per_row, plan.batch * ws.THREADS):
                for i in range(plan.batch):
                    k = base + i * ws.THREADS + t
                    slots.append(np.where(k < plan.loads_per_row, r * plan.pitch + k * plan.vec, -1))
        per_block.append(slots)
    return per_block


@pytest.mark.parametrize("byte_offset", [0, "element", 8])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_covers_window_once(shape, dtype, byte_offset):
    """Every window element is loaded exactly once, nothing outside it is
    loaded, and a vector plan's loads are 16-byte aligned."""
    esize = ESIZE[dtype]
    off = esize if byte_offset == "element" else byte_offset
    h, w, c = shape
    plan = window_sum_plan(shape, getattr(torch, dtype), off)
    aligned = off % 16 == 0 and (w * c * esize) % 16 == 0
    assert plan.instance == (ws.VECTOR if aligned else ws.SCALAR)
    assert plan.vec * esize == (16 if aligned else esize)
    assert (plan.dtype, plan.blocks, plan.batch) == (ws._DTYPE_CODE[getattr(torch, dtype)], ws.CLUSTER,
                                                     ws.BATCH[plan.instance])
    starts = np.concatenate([s for block in _plan_loads(plan) for s in block])
    starts = starts[starts >= 0]
    if plan.instance == ws.VECTOR:
        assert np.all((off + starts * esize) % 16 == 0)
    touched = (starts[:, None] + np.arange(plan.vec)).ravel()
    rows, cols = WINDOW
    assert touched.min() >= 0 and touched.max() < rows * w * c
    counts = np.bincount(touched, minlength=rows * w * c).reshape(rows, w, c)
    assert np.all(counts[:, :cols] == 1)
    assert not counts[:, cols:].any()


def _emulate(x, plan):
    """The kernel's float32 sum of the flat operand ``x`` (float32 values)
    in its order: each thread adds its loads' elements in turn, a
    shuffle-down tree adds each warp's 32 sums, the block's warp sums are
    added in order, and the cluster's block sums in rank order."""
    block_sums = []
    for slots in _plan_loads(plan):
        acc = np.zeros(ws.THREADS, np.float32)
        for start in slots:
            on = start >= 0
            for e in range(plan.vec):
                acc[on] = acc[on] + x[start[on] + e]
        lanes = acc.reshape(-1, 32)
        for o in (16, 8, 4, 2, 1):
            nxt = lanes.copy()
            nxt[:, : 32 - o] = lanes[:, : 32 - o] + lanes[:, o:]
            lanes = nxt
        s = np.float32(0)
        for i, v in enumerate(lanes[:, 0]):
            s = v if i == 0 else np.float32(s + v)
        block_sums.append(s)
    total = block_sums[0]
    for v in block_sums[1:]:
        total = np.float32(total + v)
    return total


@pytest.mark.parametrize("values", ["normal", "mixed"])
@pytest.mark.parametrize("byte_offset", [0, "element"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("shape", [(8, 16, 256), (20, 33, 3), (12, 21, 10), (20, 33, 257)])
def test_plan_order_sum_matches_plain_and_pallas(shape, dtype, byte_offset, values):
    """The sum in the plan's thread, warp, block and cluster order agrees
    with the plain version and the Pallas kernel to 1e-6 of sum |x|; the
    "mixed" values put magnitudes ~1e4 and ~1e-3 side by side."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    if values == "mixed":
        x *= np.where(rng.random(shape) < 0.5, np.float32(1e4), np.float32(1e-3))
    jx = jnp.asarray(x, getattr(jnp, dtype))
    xf = np.array(jx.astype(jnp.float32))
    esize = ESIZE[dtype]
    plan = window_sum_plan(shape, getattr(torch, dtype), esize if byte_offset == "element" else 0)
    got = float(_emulate(xf.ravel(), plan))
    plain = float(window_sum_plain(torch.from_numpy(xf).to(getattr(torch, dtype))))
    ref = float(np.asarray(_pallas_consume(jx))[0, 0])
    scale = float(np.abs(xf[: WINDOW[0], : WINDOW[1]]).sum())
    assert abs(got - plain) <= 1e-6 * scale, (got, plain)
    assert abs(got - ref) <= 1e-6 * scale, (got, ref)


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
