"""Rope + cache write against the JAX package (CPU; Pallas in interpret mode).

* ``cache_write_ref``, the cache half, equals the JAX package's fused
  kernel bit for bit: the same single-rounding rotation and the same cast
  chain (f32 -> activation dtype -> cache dtype, float8 overflow to NaN),
  the end clamp included.
* Each launch form's wrapper (solo, batched, verify) on CPU tensors runs
  its plain version: q rotated must equal JAX's jitted ``apply_rope`` of q
  and both caches JAX's ``rope_cache_update*`` bit for bit, with the
  angles each form's own rule gathers — the solo end clamp, a batched row
  past S, and verify rows whose angle row (min(pos + t, S - 1)) and write
  row (clamp(pos, 0, S - T) + t) part near the end of the cache.
* A wrapper fed the strided q, k, v slices of a fused qkv projection gives
  the bits of one fed contiguous copies, and it raises on a bad shape,
  dtype, device or position vector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dllama_tpu.ops import fused_rope_cache as j_frc
from dllama_tpu.ops.rope import HALF, INTERLEAVED, apply_rope, rope_table
from dllama_tpu_torch import kernels
from dllama_tpu_torch.ops import fused_rope_cache as t_frc
from dllama_tpu_torch.ops.rope import apply_rope as t_apply_rope

ACT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
CACHE = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16),
         "f8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}

_J_ROPE = jax.jit(apply_rope, static_argnums=3)

L, S, H, KV, HD = 2, 16, 4, 2, 32
#: (form, T, positions): the solo end clamp (14 + 3 > S: rows 13..15), a
#: batched row past S (clamped to S - 1), verify rows at S - T and near the
#: end (S - 2 + 5 > S: angles clamp at S - 1 while the writes start at S - T)
FORMS = [("solo", 1, [5]), ("solo", 3, [14]), ("batched", 1, [0, 5, S - 1, S + 2]),
         ("verify", 5, [0, 9, S - 5, S - 2])]


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.uint8).numpy()
    return np.asarray(a).view(np.uint8)


@pytest.mark.parametrize("style", [INTERLEAVED, HALF])
@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("T,pos", [(1, 5), (3, 14)])  # 14 + 3 > S=16: start clamps to 13
def test_rope_cache_ref_bit_equal_to_jax_kernel(style, act, cache, T, pos):
    rng = np.random.default_rng(T + pos)
    L, S, kv, hd = 2, 16, 2, 32
    k = rng.standard_normal((T, kv, hd)).astype(np.float32) * 4
    v = rng.standard_normal((T, kv, hd)).astype(np.float32) * 4
    cos, sin = rope_table(S + T, hd, 10000.0)
    c, s = cos[pos:pos + T, None], sin[pos:pos + T, None]
    base = rng.standard_normal((L, S, kv, hd)).astype(np.float32)
    ja, ta = ACT[act]
    jc, tc = CACHE[cache]
    kj, vj = j_frc.rope_cache_update(
        jnp.asarray(k).astype(ja), jnp.asarray(v).astype(ja), jnp.asarray(c), jnp.asarray(s),
        jnp.array(base).astype(jc), jnp.array(base + 1).astype(jc), jnp.int32(pos), jnp.int32(1),
        style)
    kt = torch.from_numpy(base).to(tc)
    vt = torch.from_numpy(base + 1).to(tc)
    t_frc.cache_write_ref(torch.from_numpy(k).to(ta), torch.from_numpy(v).to(ta),
                          torch.from_numpy(c), torch.from_numpy(s), kt, vt, pos, 1, style)
    np.testing.assert_array_equal(_bits(kj), _bits(kt))
    np.testing.assert_array_equal(_bits(vj), _bits(vt))


def test_f8_cast_overflows_to_nan_like_the_reference():
    vals = np.array([1.0, 447.0, 448.0, 460.0, 464.0, 465.0, 480.0, 1e6, -1e6, np.inf,
                     np.nan, 1e-10, 0.0019], np.float32)
    j = np.asarray(jnp.asarray(vals).astype(jnp.float8_e4m3fn).astype(jnp.float32))
    t = t_frc.cast_cache(torch.from_numpy(vals), torch.float8_e4m3fn).float().numpy()
    np.testing.assert_array_equal(np.isnan(j), np.isnan(t))
    np.testing.assert_array_equal(j[~np.isnan(j)], t[~np.isnan(t)])


def _inputs(form: str, T: int, pos: list, seed: int) -> dict:
    """Seeded q, k, v [*rows, heads, hd] (f32, x4 so f8 overflows somewhere),
    caches [L, (B,) S, kv, hd], the f32 tables and the positions."""
    rng = np.random.default_rng(seed)
    B = len(pos)
    rows = {"solo": (T,), "batched": (B,), "verify": (B, T)}[form]
    cache = (L, S, KV, HD) if form == "solo" else (L, B, S, KV, HD)
    cos, sin = rope_table(S, HD, 10000.0)
    return {"q": rng.standard_normal((*rows, H, HD)).astype(np.float32) * 4,
            "k": rng.standard_normal((*rows, KV, HD)).astype(np.float32) * 4,
            "v": rng.standard_normal((*rows, KV, HD)).astype(np.float32) * 4,
            "kc": rng.standard_normal(cache).astype(np.float32),
            "cos": cos, "sin": sin, "pos": np.array(pos, np.int32)}


def _jax_step(form: str, d: dict, ja, jc, style: str) -> tuple:
    """JAX's apply_rope of q and its fused kernel's cache write, with the
    angles the JAX model gathers for the form."""
    pos, T = d["pos"], d["q"].shape[-3]
    if form == "solo":
        r0 = min(max(int(pos[0]), 0), S - T)  # dynamic_slice clamps
        c, s = d["cos"][r0:r0 + T, None], d["sin"][r0:r0 + T, None]
    elif form == "batched":
        rows = np.minimum(pos, S - 1)  # the gather clamps
        c, s = d["cos"][rows][:, None], d["sin"][rows][:, None]
    else:
        rows = np.minimum(pos[:, None] + np.arange(T), S - 1)
        c, s = d["cos"][rows][:, :, None], d["sin"][rows][:, :, None]
    c, s = jnp.asarray(c), jnp.asarray(s)
    q_rot = _J_ROPE(jnp.asarray(d["q"]).astype(ja), c, s, style)
    fn = {"solo": j_frc.rope_cache_update, "batched": j_frc.rope_cache_update_batched,
          "verify": j_frc.rope_cache_update_verify}[form]
    p = jnp.int32(pos[0]) if form == "solo" else jnp.asarray(pos)
    kc, vc = fn(jnp.asarray(d["k"]).astype(ja), jnp.asarray(d["v"]).astype(ja), c, s,
                jnp.array(d["kc"]).astype(jc), jnp.array(d["kc"] + 1).astype(jc), p,
                jnp.int32(1), style)
    return q_rot, kc, vc


def _port_step(form: str, d: dict, ta, tc, style: str, q=None, k=None, v=None) -> tuple:
    """The port's wrapper for the form on CPU tensors: (q rotated, caches)."""
    q = torch.from_numpy(d["q"]).to(ta) if q is None else q
    k = torch.from_numpy(d["k"]).to(ta) if k is None else k
    v = torch.from_numpy(d["v"]).to(ta) if v is None else v
    kc = torch.from_numpy(d["kc"]).to(tc, copy=True)
    vc = torch.from_numpy(d["kc"] + 1).to(tc)
    fn = {"solo": t_frc.rope_cache_update, "batched": t_frc.rope_cache_update_batched,
          "verify": t_frc.rope_cache_update_verify}[form]
    pos = int(d["pos"][0]) if form == "solo" else torch.from_numpy(d["pos"])
    q_rot = fn(q, k, v, torch.from_numpy(d["cos"]), torch.from_numpy(d["sin"]), kc, vc, pos, 1,
               style)
    return q_rot, kc, vc


@pytest.mark.parametrize("style", [INTERLEAVED, HALF])
@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("cache", ["f32", "bf16", "f8"])
@pytest.mark.parametrize("form,T,pos", FORMS)
def test_rope_launch_plain_version_bit_equal_to_jax(form, T, pos, style, act, cache):
    d = _inputs(form, T, pos, seed=len(form) + T + len(act) + len(cache))
    ja, ta = ACT[act]
    jc, tc = CACHE[cache]
    qj, kj, vj = _jax_step(form, d, ja, jc, style)
    before = dict(kernels.launches)
    qt, kt, vt = _port_step(form, d, ta, tc, style)
    assert kernels.launches == before  # CPU tensors: the plain version, no launch
    assert qt.dtype == ta and qt.shape == d["q"].shape and qt.is_contiguous()
    np.testing.assert_array_equal(_bits(qj), _bits(qt))
    np.testing.assert_array_equal(_bits(kj), _bits(kt))
    np.testing.assert_array_equal(_bits(vj), _bits(vt))


def test_verify_rule_parts_angle_from_write_row():
    """The verify form's trap: near the end of the cache a row's angle row
    and its write row differ, so the form must not take the solo rule."""
    d = _inputs("verify", 5, [S - 2], seed=3)
    q_rot, kc, _ = _port_step("verify", d, torch.float32, torch.float32, INTERLEAVED)
    cos, sin = torch.from_numpy(d["cos"]), torch.from_numpy(d["sin"])
    q = torch.from_numpy(d["q"])
    solo_rows = t_apply_rope(q[0], cos[S - 5:S, None], sin[S - 5:S, None])
    assert not torch.equal(q_rot[0], solo_rows)  # the write rows' angles: wrong
    angle = [min(S - 2 + t, S - 1) for t in range(5)]
    assert torch.equal(q_rot[0], t_apply_rope(q[0], cos[angle, None], sin[angle, None]))
    base = torch.from_numpy(d["kc"][1, 0])
    assert torch.equal(kc[1, 0, :S - 5], base[:S - 5])  # written at S - 5.., no earlier
    assert not torch.equal(kc[1, 0, S - 5:], base[S - 5:])


@pytest.mark.parametrize("act", ["f32", "bf16"])
@pytest.mark.parametrize("form,T,pos", FORMS)
def test_rope_launch_strided_qkv_bit_equal_to_contiguous(form, T, pos, act):
    """q, k, v as the slices of one fused [rows, (H + 2 kv) hd] projection,
    as the decode step hands them over, against contiguous copies."""
    d = _inputs(form, T, pos, seed=T + len(pos))
    ta = ACT[act][1]
    tc = torch.bfloat16
    lead = d["q"].shape[:-2]
    qkv = torch.from_numpy(np.concatenate(
        [d[n].reshape(-1, d[n].shape[-2] * HD) for n in ("q", "k", "v")], axis=1)).to(ta)
    q, k, v = (t.reshape(*lead, -1, HD)
               for t in (qkv[:, :H * HD], qkv[:, H * HD:(H + KV) * HD], qkv[:, (H + KV) * HD:]))
    if q.numel() > H * HD:
        assert t_frc._rows("q", q).stride(0) == (H + 2 * KV) * HD
    strided = _port_step(form, d, ta, tc, INTERLEAVED, q, k, v)
    flat = _port_step(form, d, ta, tc, INTERLEAVED)
    for a, b in zip(strided, flat):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _bad(case: str) -> tuple:
    """(wrapper, its arguments, the exception) for one malformed call."""
    d = _inputs("verify", 3, [0, 4], seed=1)
    t = {n: torch.from_numpy(d[n]) for n in ("q", "k", "v", "cos", "sin")}
    kc = torch.from_numpy(d["kc"])
    pos = torch.from_numpy(d["pos"])
    args = dict(q=t["q"], k=t["k"], v=t["v"], cos=t["cos"], sin=t["sin"], k_cache=kc,
                v_cache=kc.clone(), pos=pos, layer=1)
    fn, exc = t_frc.rope_cache_update_verify, ValueError
    if case == "kv heads":
        args["k"] = t["k"][:, :, :1]
    elif case == "too many rows":
        args.update(q=torch.zeros(2, 17, H, HD), k=torch.zeros(2, 17, KV, HD),
                    v=torch.zeros(2, 17, KV, HD))
    elif case == "layer":
        args["layer"] = L
    elif case == "table width":
        args.update(cos=t["cos"][:, :-1], sin=t["sin"][:, :-1])
    elif case == "activation dtype":
        args["q"], exc = t["q"].half(), TypeError
    elif case == "cache dtype":
        args.update(k_cache=kc.double(), v_cache=kc.double())
        exc = TypeError
    elif case == "table dtype":
        args.update(cos=t["cos"].double(), sin=t["sin"].double())
        exc = TypeError
    elif case == "device":
        args["q"] = t["q"].to("meta")
    elif case == "cache device":
        args.update({n: a.to("meta") for n, a in args.items() if isinstance(a, torch.Tensor)})
    elif case == "position dtype":
        args["pos"] = pos.long()
    elif case == "solo tables short":
        fn = t_frc.rope_cache_update
        args.update(q=t["q"][0], k=t["k"][0], v=t["v"][0], k_cache=kc[:, 0],
                    v_cache=kc[:, 0].clone(), cos=t["cos"][:S - 1], sin=t["sin"][:S - 1], pos=0)
    elif case == "batched rows":
        fn = t_frc.rope_cache_update_batched
        args.update(q=t["q"][:1, 0], k=t["k"][:1, 0], v=t["v"][:1, 0])
    return fn, args, exc


@pytest.mark.parametrize("case", ["kv heads", "too many rows", "layer", "table width",
                                  "activation dtype", "cache dtype", "table dtype", "device",
                                  "cache device", "position dtype", "solo tables short",
                                  "batched rows"])
def test_rope_launch_wrappers_reject_bad_operands(case):
    fn, args, exc = _bad(case)
    before = {n: a.clone() for n, a in args.items()
              if n.endswith("cache") and a.device.type == "cpu"}
    with pytest.raises(exc):
        fn(**args)
    for n, a in before.items():  # nothing written
        assert torch.equal(args[n], a)


def test_rope_rows_refuse_layouts_the_kernel_cannot_stride():
    x = torch.zeros(3, 4, 32)
    assert t_frc._rows("x", x).stride(0) == 128
    assert t_frc._rows("x", torch.zeros(3, 200)[:, 40:168].reshape(3, 4, 32)).stride(0) == 200
    with pytest.raises(ValueError, match="adjacent heads"):
        t_frc._rows("x", x.transpose(0, 1))
    with pytest.raises(ValueError, match="adjacent heads"):
        t_frc._rows("x", torch.zeros(3, 4, 64)[..., ::2])
