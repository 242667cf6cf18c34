"""The initial weights of the JAX package's Flax VSS, drawn without JAX.

``flax_variables(cfg, image_hw, seed)`` returns what
``VSS(cfg).init({"params": jax.random.key(seed), ...},
zeros((1, H, W, 3)), train=False)`` returns in the JAX package, as nested
dicts of numpy arrays for ``vss.from_flax``: the same pseudo-random
stream, so the port can run the very network the JAX package's examples
and bench build from a seed (examples/run_loop_closure.py builds its VSS
from key 2). The machine with the card has no JAX, so the stream is
reproduced here:

* JAX's threefry-2x32 PRNG: a key is a pair of uint32 (a seed s gives
  (s >> 32, s & 0xffffffff)); ``fold_in`` hashes (0, data) under the key;
  random bits (the "partitionable" layout, JAX's default) are the two
  hash words of the element's flat index XORed;
* Flax's key of a parameter: the root key folded with the first 4 bytes
  (big-endian) of the SHA-1 of its scope path and the scope's parameter
  counter (1 for a conv's kernel, 2 for its bias; the VSS's own offsets
  count at its top scope);
* the initializers: ``lecun_normal`` (variance scaling 1/fan_in, a normal
  truncated to ±2 through erf / erf⁻¹, then / 0.8796), zero biases,
  BatchNorm scale 1 / bias 0 / mean 0 / var 1, ``normal(1.0)`` offsets.

Floats follow JAX's float32 steps, erf⁻¹ XLA's float32 polynomial; erf
(of ±√2 only) and log1p are numpy's, so a weight can differ from Flax's
in its last bit or two (tests/test_torch_vss.py holds them to 1e-6
relative).
"""

from __future__ import annotations

import hashlib
import math

import numpy as np
import torch

from ekf_slam_tpu_torch.models import vss

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(key, x0: np.ndarray, x1: np.ndarray):
    """The Threefry-2x32 hash (20 rounds) of the count pairs (x0, x1)."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        x = [x0.astype(_U32) + ks[0], x1.astype(_U32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = (x[1] << _U32(r)) | (x[1] >> _U32(32 - r))
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x


def prng_key(seed: int):
    """jax.random.key(seed)'s key data."""
    return (_U32((seed >> 32) & 0xFFFFFFFF), _U32(seed & 0xFFFFFFFF))


def fold_in(key, data: int):
    """jax.random.fold_in(key, data)."""
    y0, y1 = _threefry2x32(key, np.zeros(1, _U32), np.array([data], _U32))
    return (y0[0], y1[0])


def random_bits(key, shape) -> np.ndarray:
    """32 random bits an element (JAX's partitionable threefry layout)."""
    n = math.prod(shape)
    b1, b2 = _threefry2x32(key, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return (b1 ^ b2).reshape(shape)


def uniform(key, shape, minval, maxval) -> np.ndarray:
    """jax.random.uniform at float32."""
    bits = (random_bits(key, shape) >> _U32(9)) | _U32(0x3F800000)
    floats = bits.view(np.float32) - np.float32(1.0)
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = floats.astype(np.float64) * (hi - lo) + lo       # one FMA
    return np.maximum(lo, scaled.astype(np.float32))


# XLA's float32 erf⁻¹ (M. Giles' single-precision polynomials in
# w = −log(1 − x²), split at w = 5), each step one fused multiply-add.
_ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                  -4.39150654e-06, 0.00021858087, -0.00125372503,
                  -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322,
                  -0.00367342844, 0.00573950773, -0.0076224613,
                  0.00943887047, 1.00167406, 2.83297682)


def _erf(x):
    return np.float32(math.erf(float(x)))


def _erfinv(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.float32)
    w = -np.log1p(-x * x).astype(np.float32)
    lt = w < np.float32(5.0)
    w = np.where(lt, w - np.float32(2.5),
                 np.sqrt(w) - np.float32(3.0)).astype(np.float64)
    coef = np.where(lt[..., None], np.float32(_ERFINV_W_LT_5),
                    np.float32(_ERFINV_W_GE_5)).astype(np.float64)
    p = coef[..., 0].astype(np.float32)
    for i in range(1, len(_ERFINV_W_LT_5)):
        p = (coef[..., i] + p.astype(np.float64) * w).astype(np.float32)
    return p * x


def truncated_normal(key, shape, lower=-2.0, upper=2.0) -> np.ndarray:
    """jax.random.truncated_normal at float32."""
    sqrt2 = np.float32(np.sqrt(2))
    lo, hi = np.float32(lower), np.float32(upper)
    u = uniform(key, shape, _erf(lo / sqrt2), _erf(hi / sqrt2))
    return np.clip(sqrt2 * _erfinv(u), np.nextafter(lo, np.float32(np.inf)),
                   np.nextafter(hi, np.float32(-np.inf)))


def normal(key, shape) -> np.ndarray:
    """jax.random.normal at float32."""
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    return np.float32(np.sqrt(2)) * _erfinv(uniform(key, shape, lo, 1.0))


def param_key(root, path) -> tuple:
    """Flax's key of the parameter at `path` (scope names, then the
    scope's parameter counter)."""
    m = hashlib.sha1()
    for x in path:
        m.update(x.encode() if isinstance(x, str)
                 else x.to_bytes((x.bit_length() + 7) // 8, "big"))
    return fold_in(root, int.from_bytes(m.digest()[:4], "big"))


def lecun_normal(key, shape) -> np.ndarray:
    """Flax's default conv kernel init; shape HWIO (fan-in = all but O)."""
    variance = np.float32(1.0 / math.prod(shape[:-1]))
    stddev = np.sqrt(variance) / np.float32(0.87962566103423978)
    return truncated_normal(key, shape) * stddev


def _conv(root, path, shape, bias: bool) -> dict:
    p = {"kernel": lecun_normal(param_key(root, path + (1,)), shape)}
    if bias:
        p["bias"] = np.zeros(shape[-1], np.float32)
    return p


def _block(root, path, shape):
    n = shape[-1]
    params = {"Conv_0": _conv(root, path + ("Conv_0",), shape, False),
              "BatchNorm_0": {"scale": np.ones(n, np.float32),
                              "bias": np.zeros(n, np.float32)}}
    stats = {"BatchNorm_0": {"mean": np.zeros(n, np.float32),
                             "var": np.ones(n, np.float32)}}
    return params, stats


def flax_variables(cfg: vss.VSSConfig, image_hw, seed: int) -> dict:
    """{"params", "batch_stats"} of the Flax VSS(cfg) initialized at
    image_hw from jax.random.key(seed)."""
    vss.check_config(cfg)
    root = prng_key(seed)
    H, W = image_hw
    w, heads, lat = cfg.width, cfg.heads, cfg.latent_ch
    params, stats = {}, {}

    enc_p, enc_s = {}, {}
    with torch.device("meta"):
        enc = vss.Encoder(cfg)
        dec = vss.Decoder(cfg)
    for pos, idx in enumerate(vss.ENCODER_FLAX_INDEX):
        o, i, kh, kw = enc.blocks[pos].conv.weight.shape
        name = f"ConvBNElu_{idx}"
        enc_p[name], enc_s[name] = _block(root, ("Encoder_0", name, ),
                                          (kh, kw, i, o))
    params["Encoder_0"], stats["Encoder_0"] = enc_p, enc_s
    dec_p, dec_s = {}, {}
    for k, blk in enumerate(dec.blocks):
        o, i, kh, kw = blk.conv.weight.shape
        name = f"GroupedConvBNElu_{k}"
        dec_p[name], dec_s[name] = _block(root, ("Decoder_0", name),
                                          (kh, kw, i, o))
    dec_p["Conv_0"] = _conv(root, ("Decoder_0", "Conv_0"),
                            (1, 1, 16, vss.LATENT_PER_HEAD * heads), True)
    params["Decoder_0"], stats["Decoder_0"] = dec_p, dec_s

    params["mu"] = _conv(root, ("mu",), (3, 3, 16 * w, lat), True)
    counter = 0
    if cfg.descr_source in ("d5", "multi"):
        counter += 1
        params["offset"] = normal(param_key(root, (counter,)), (
            1, vss.pooled(H, 4), vss.pooled(W, 4), lat))
    if cfg.descr_source in ("d4", "multi"):
        params["mu_d4"] = _conv(root, ("mu_d4",), (3, 3, 8 * w, lat), True)
        counter += 1
        params["offset_d4"] = normal(param_key(root, (counter,)), (
            1, vss.pooled(H, 3), vss.pooled(W, 3), lat))
    params["log_sig_sq"] = _conv(root, ("log_sig_sq",),
                                 (3, 3, 16 * w, lat), True)
    return {"params": params, "batch_stats": stats}
