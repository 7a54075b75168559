"""Multi-head attention — kernels K1, K3, K4, K5, K7 and K10 — and the rule
that routes between them (port of the JAX package's ``ops/attention.py``).

  * ``fused_attention_packed`` (K1) replaces the TPU kernel ``_packed_kernel``
    (clip_assisted_data_labeling_tpu/ops/attention.py, ``pallas_call`` at
    :1124) with ``csrc/packed_attention.cu``: exact two-pass softmax per head,
    with the optional in-kernel half-split RoPE of the PE towers and the
    optional ``quant_out`` (int8 output with a float32 scale per token, for
    the dynamic-int8 ``xla`` and ``hybrid`` blocks). K4 and K5 have no
    ``quant_out``, as in the JAX package, whose int8 blocks call the
    whole-block kernel directly.
  * ``fused_attention_packed_grouped`` (K4) replaces ``_packed_grouped_kernel``
    (``pallas_call`` at :342) with ``csrc/packed_attention_grouped.cu``: the
    same exact two-pass softmax (and RoPE), with the keys streamed in both
    passes so no sequence length bounds it.
  * ``flash_attention_packed`` (K5) replaces ``_flash_kernel`` (``pallas_call``
    at :599) with ``csrc/flash_attention.cu``: online softmax over k panels,
    with its RoPE option.
  * ``fused_attention_packed_q8s`` (K3) replaces ``_packed_q8s_kernel``
    (``pallas_call`` at :834) with ``csrc/packed_attention_q8s.cu``: the
    static-scale int8 attention wire of the int8_static blocks.
  * ``fused_attention_packed_q8`` (K7) replaces ``_packed_q8_kernel``
    (``pallas_call`` at :713) with ``csrc/packed_attention_q8.cu``: int8 qkv
    with one float32 scale per token, bf16/f32 out or K1's ``quant_out``.
  * ``fused_attention`` (K10) replaces ``_attn_kernel`` (``pallas_call`` at
    :107) with K1's kernels in ``csrc/packed_attention.cu`` read through the
    strides of unpacked ``[B, h, S, d]`` q, k and v.

No entry point of the JAX package calls K7 or K10, nor runs K5 with RoPE
(every registered RoPE tower routes to K1 or K4); each is ported as a kernel
in its own right.
  * ``attention_xla`` is the JAX package's materializing reference path, which
    its calibration forward runs; plain ``torch.matmul`` products here too.

Each kernel's header says what bounds it on the H100 and how the design
answers that. Dispatch: a CPU tensor goes to the plain PyTorch version beside
the kernel; a CUDA tensor launches the kernel or raises.

Routing. The JAX package picks a kernel by its TPU VMEM budget
(``packed_attention_fits`` → whole-block, ``grouped_attention_fits`` →
head-grouped, else flash). The kernels round differently: whole-block and
grouped run the exact two-pass softmax, flash rounds P against a running max
at its k-panel boundaries. So the port keeps the JAX package's gate
arithmetic verbatim (``_round_up`` … ``_flash_tiles`` below), not as a memory
budget — the H100 kernels take every shape either way — but as the rule that
picks the kernel for ``(S, width, heads, dtype)``: the one the JAX package
would run, K1 for whole-block, K4 for grouped, K5 (with the JAX package's
panel boundaries) for flash. The grouped kernel's ``whole_scores`` schedule
(on by default in the JAX package for long sequences) computes the same
arithmetic as its row-tiled mode in another order on the TPU; it has no
counterpart here, and ``_wholescore_group`` stays TPU-only. Tokens stay
unpadded in the port (the kernels mask keys at or beyond ``s_real`` and the
ragged last tile), so the RoPE tables have exactly S rows.

Per-sequence lengths. ``s_real`` is an int (every sequence's keys end there)
or an int32 tensor [B] on the qkv's device (the naflex towers' native-aspect
rows, padded to one length): sequence b attends to its keys [0, s_real[b]),
and its query rows at or past s_real[b] come out as zeros. In bfloat16 K1 and
K5 take the lengths in the kernel (``packed_attention_varlen``,
``flash_attention_varlen``; each wrapper counts those launches in
``varlen_launches``), skipping the key chunks, K5's panels and the query
tiles past a sequence's end, into an output allocated as zeros; in float32
the wrappers launch once a sequence with its length as ``s_real``.
:func:`packed_attention_auto` sends the grouped route's lengths to K1, which
computes K4's function.

RoPE (PE towers): ``rope = (cos, sin)``, each ``[S, d/2]`` float32, pairs the
features (i, i + d/2) of every head (``models/vit._rope2d_tables``). K1 and
K4 scale q in the input dtype and then rotate it, and rotate k unscaled, with
the tables cast to the input dtype — the TPU kernels' order. The XLA-style
path (``models/vit._apply_rope`` then :func:`attention_xla`) rotates unscaled
q instead; the two round differently in bf16, and each side of the port
copies its own JAX counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from clip_assisted_data_labeling_tpu_torch.ops import _cuda_build
from clip_assisted_data_labeling_tpu_torch.ops.quant_kernel import (
    _rowquant_launch,
    rowquant_plain,
)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---- the JAX package's gate arithmetic (attention.py:48-147, :384-397,
# :514-525), kept as the rule that picks the arithmetic ------------------------

def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _dividing_tile(s_pad: int, lo: int, hi: int, key) -> int | None:
    """The 8-multiple divisor of ``s_pad`` in [lo, hi] minimizing ``key``
    (ties → smallest), or None."""
    cands = [t for t in range(lo, hi + 1, 8) if s_pad % t == 0]
    return min(cands, key=key) if cands else None


def _q_tile(s_pad: int) -> int:
    if s_pad <= 448:
        return s_pad
    return _dividing_tile(s_pad, 128, 448, key=lambda t: -t) or 256


def _pad_for_tiling(s: int) -> int:
    base = _round_up(s, 8)
    if base <= 448:
        return base
    for extra in range(0, 65, 8):
        sp = base + extra
        if sp % _q_tile(sp) == 0:
            return sp
    return base


def packed_attention_fits(s: int, width: int, itemsize: int = 2) -> bool:
    """The JAX package's whole-block gate (its ~14 MB VMEM budget)."""
    s_pad = _pad_for_tiling(s)
    q_tile = _q_tile(s_pad)
    blocks = 2 * s_pad * 4 * width * itemsize
    working = 2 * q_tile * s_pad * 4 + 4 * s_pad * width
    return blocks + working <= 14 * 2**20


def grouped_attention_fits(s: int, width: int, heads: int, itemsize: int = 2) -> bool:
    """The JAX package's head-grouped gate."""
    s_pad = _pad_for_tiling(s)
    d = width // heads
    wg = d
    while wg % 128 != 0:
        wg += d
    q_tile = _q_tile(s_pad)
    blocks = 2 * (3 * s_pad * wg + s_pad * wg) * itemsize
    working = 2 * q_tile * s_pad * 4
    return blocks + working <= 14 * 2**20


def packed_q8s_fits(s: int, width: int, heads: int) -> bool:
    """The JAX package's gate for the int8 wire kernel (K3)."""
    d = width // heads
    s_pad = _pad_for_tiling(s)
    q_tile = _q_tile(s_pad)
    blocks = 2 * (s_pad * 4 * width)
    kv = heads * 2 * s_pad * d * 2
    working = 2 * q_tile * s_pad * 4 + 3 * q_tile * d * 4
    return blocks + working + kv <= 14 * 2**20


def _flash_tiles(s_pad: int) -> tuple[int, int, int]:
    """(padded S, q_tile, k_panel) of the JAX package's flash kernel."""
    cand = _dividing_tile(s_pad, 128, 768, key=lambda t: abs(t - 384))
    if cand is not None:
        return s_pad, cand, cand
    if s_pad <= 768:
        return s_pad, s_pad, s_pad
    s2 = _round_up(s_pad, 256)
    return s2, 256, 256


def flash_panel(s: int) -> int:
    """Keys per k panel where the JAX package's flash kernel would run S
    tokens (368 at S=729): the boundaries at which K5 rescales."""
    return _flash_tiles(_round_up(s, 8))[2]


def attention_route(s: int, width: int, heads: int, itemsize: int) -> str:
    """'packed' (K1), 'grouped' (K4) or 'flash' (K5), as the JAX package's
    ``packed_attention_auto`` decides for S tokens of ``itemsize``-byte qkv
    (with its default knobs)."""
    if packed_attention_fits(s, width, itemsize):
        return "packed"
    if grouped_attention_fits(s, width, heads, itemsize):
        return "grouped"
    return "flash"


def packed_attention_auto(qkv: torch.Tensor, heads: int, scale: float,
                          s_real: int | torch.Tensor | None = None, rope=None) -> torch.Tensor:
    """The attention of every float block and of the int8_static lnk and
    static blocks: K1, K4 or K5 by :func:`attention_route`. ``rope``:
    (cos, sin) tables [S, d/2] or None. ``s_real``: an int, or per-sequence
    lengths [B] (the grouped route's then go to K1, the same function)."""
    b, s, w3 = qkv.shape
    route = attention_route(s, w3 // 3, heads, qkv.element_size())
    if route == "packed" or (route == "grouped" and torch.is_tensor(s_real)):
        return fused_attention_packed(qkv, heads, scale, s_real, rope)
    if route == "grouped":
        return fused_attention_packed_grouped(qkv, heads, scale, s_real, rope)
    return flash_attention_packed(qkv, heads, scale, s_real, rope)


def _split_heads(qkv: torch.Tensor, heads: int):
    b, s, w3 = qkv.shape
    w = w3 // 3
    return tuple(t.reshape(b, s, heads, w // heads).permute(0, 2, 1, 3)
                 for t in qkv.split(w, dim=-1))


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, s, h * d)


def _check_packed(what: str, qkv: torch.Tensor, heads: int, s_real: int, dtypes) -> None:
    if qkv.dim() != 3 or qkv.dtype not in dtypes or not qkv.is_contiguous():
        raise ValueError(
            f"{what} wants a contiguous [B, S, 3w] tensor of {sorted(map(str, dtypes))}, "
            f"got {tuple(qkv.shape)} {qkv.dtype} contiguous={qkv.is_contiguous()}"
        )
    b, s, w3 = qkv.shape
    w = w3 // 3
    if torch.is_tensor(s_real):  # per-sequence lengths: values stay on the device
        if (s_real.dtype != torch.int32 or tuple(s_real.shape) != (b,)
                or s_real.device != qkv.device or not s_real.is_contiguous()):
            raise ValueError(
                f"{what}: per-sequence lengths must be a contiguous int32 [{b}] tensor on "
                f"{qkv.device}, got {tuple(s_real.shape)} {s_real.dtype} on {s_real.device}"
            )
        s_real = s
    if w3 % 3 or w % heads or w // heads > 128 or not 1 <= s_real <= s:
        raise ValueError(
            f"{what}: bad shape {tuple(qkv.shape)} for {heads} heads, "
            f"s_real={s_real} (head dim must be <= 128)"
        )


def _rot_half(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Half-split RoPE (the JAX ``_rot_half``, attention.py:850, and
    ``models/vit._apply_rope``): pairs (i, i + d/2) of the last dim,
    ``[x1·cos − x2·sin, x1·sin + x2·cos]`` with tables [S, d/2] in x's dtype.
    Each product and then the sum rounds to x's dtype: the JAX code does so
    under jit and op by op, and the interpret-mode Pallas kernels equal this
    bit for bit in bf16."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention_xla(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  scale: float) -> torch.Tensor:
    """The JAX package's reference path (attention.py:159), [B, h, S, d]:
    float32 scores from the input-dtype q and k, softmax of scores·scale in
    float32, probabilities cast to v's dtype, P·V in the input dtype."""
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    probs = torch.softmax(scores * scale, dim=-1).to(v.dtype)
    return torch.matmul(probs, v)


def _rope_tables(what: str, qkv: torch.Tensor, heads: int, rope):
    """(cos, sin) cast to qkv's dtype on its device, contiguous, after
    checking their shape [S, d/2]; (None, None) without RoPE."""
    if rope is None:
        return None, None
    s, w3 = qkv.shape[1:]
    d = w3 // 3 // heads
    cos, sin = rope
    if d % 2 or tuple(cos.shape) != (s, d // 2) or tuple(sin.shape) != (s, d // 2):
        raise ValueError(f"{what}: RoPE tables must be [{s}, {d // 2}] each for head dim {d}, "
                         f"got {tuple(cos.shape)} and {tuple(sin.shape)}")
    return (cos.to(qkv.device, qkv.dtype).contiguous(),
            sin.to(qkv.device, qkv.dtype).contiguous())


def _exact_softmax_plain(qkv: torch.Tensor, heads: int, scale: float, s_real: int | None,
                         rope) -> torch.Tensor:
    """The arithmetic of the TPU's whole-block and head-grouped kernels (K1
    and K4 compute the same function): q·scale in the input dtype (the scale
    cast to it first), then q and k rotated with the tables in the input
    dtype, float32 scores with an exact -inf mask on keys ≥ s_real, float32
    softmax statistics, P cast to v's dtype before P·V, 1/sum applied after,
    the result rounded to the input dtype."""
    return _exact_softmax_f32(qkv, heads, scale, s_real, rope).to(qkv.dtype)


def _exact_softmax_f32(qkv: torch.Tensor, heads: int, scale: float, s_real: int | None,
                       rope) -> torch.Tensor:
    """:func:`_exact_softmax_plain` before the last rounding: the float32
    head outputs [B, S, w]."""
    cos, sin = _rope_tables("attention", qkv, heads, rope)
    return _merge_heads(_exact_heads_f32(*_split_heads(qkv, heads), scale, s_real, cos, sin))


def _key_mask(s_real: torch.Tensor, s: int) -> torch.Tensor:
    """[B, 1, 1, S]: True at the keys (or query rows) at or past each
    sequence's length."""
    return (torch.arange(s, device=s_real.device)[None, :] >= s_real.long()[:, None])[:, None, None]


def _zero_past(out: torch.Tensor, s_real) -> torch.Tensor:
    """[B, h, S, d] head outputs with the query rows past each sequence's
    length set to zeros (an int ``s_real`` leaves them)."""
    if not torch.is_tensor(s_real):
        return out
    return out.masked_fill(_key_mask(s_real, out.shape[2]).transpose(-1, -2), 0.0)


def _exact_heads_f32(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                     s_real, cos=None, sin=None) -> torch.Tensor:
    """The exact two-pass softmax on [B, h, S, d] heads, to float32 outputs
    (see :func:`_exact_softmax_plain`); ``cos``, ``sin`` in q's dtype or
    None; ``s_real`` an int, None or per-sequence lengths [B]."""
    s = q.shape[2]
    s_real = s if s_real is None else s_real
    q = q * torch.tensor(scale, dtype=q.dtype, device=q.device)
    if cos is not None:
        q, k = _rot_half(q, cos, sin), _rot_half(k, cos, sin)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if torch.is_tensor(s_real):
        scores = scores.masked_fill(_key_mask(s_real, s), float("-inf"))
    elif s_real < s:
        scores[..., s_real:] = float("-inf")
    m = scores.amax(dim=-1, keepdim=True)
    probs = torch.exp(scores - m)
    inv_norm = 1.0 / probs.sum(dim=-1, keepdim=True)
    return _zero_past(torch.matmul(probs.to(v.dtype).float(), v.float()) * inv_norm, s_real)


def _launch_packed(what: str, lib_fn, qkv: torch.Tensor, heads: int, scale: float,
                   s_real, rope, out_dtype=None, panel: int | None = None) -> torch.Tensor:
    """Check the inputs of K1, K4 or K5 and launch its C entry on the current
    stream; returns the [B, S, w] output (of ``out_dtype``, by default the
    input's). ``panel`` (K5): the keys per k panel, passed after the scale.
    Every entry takes one more pointer after the RoPE tables, to a [B, S, 2w]
    tensor for its bf16 RoPE pre-pass, or null where it runs none. With
    per-sequence lengths ``s_real`` [B], ``lib_fn`` is a varlen entry, which
    takes S as its ``s_real`` and the lengths' pointer after the scratch."""
    b, s, w3 = qkv.shape
    s_real = s if s_real is None else s_real
    _check_packed(what, qkv, heads, s_real, _DTYPE_CODE)
    lengths = s_real if torch.is_tensor(s_real) else None
    if lengths is not None:
        if qkv.dtype != torch.bfloat16:
            raise ValueError(f"{what}: per-sequence lengths run on the bfloat16 kernel only")
        s_real = s
    w = w3 // 3
    d = w // heads
    if qkv.dtype == torch.bfloat16 and (d % 8 or qkv.data_ptr() % 16
                                        or (rope is not None and d % 16)):
        raise ValueError(
            f"{what}: the bfloat16 kernel reads 16-byte vectors — head dim {d} must be a "
            "multiple of 8 (of 16 with RoPE) and the data 16-byte aligned"
        )
    cos, sin = _rope_tables(what, qkv, heads, rope)
    # a varlen kernel writes only the rows below each sequence's length
    alloc = torch.empty if lengths is None else torch.zeros
    out = alloc((b, s, w), dtype=out_dtype or qkv.dtype, device=qkv.device)
    qk = (torch.empty((b, s, 2 * w), dtype=qkv.dtype, device=qkv.device)
          if cos is not None and qkv.dtype == torch.bfloat16 else None)
    with torch.cuda.device(qkv.device):
        err = lib_fn(
            qkv.data_ptr(), out.data_ptr(), _DTYPE_CODE[qkv.dtype], b, s, s_real, w, heads,
            float(scale), *(() if panel is None else (panel,)),
            None if cos is None else cos.data_ptr(), None if sin is None else sin.data_ptr(),
            None if qk is None else qk.data_ptr(),
            *(() if lengths is None else (lengths.data_ptr(),)),
            torch.cuda.current_stream(qkv.device).cuda_stream,
        )
    _cuda_build.check(err, what)
    return out


def _per_sequence(launch, qkv: torch.Tensor, lengths: torch.Tensor, rope) -> torch.Tensor:
    """A float32 qkv with per-sequence lengths on the card: ``launch(qkv_b,
    s_real, rope)`` once a sequence, its length as ``s_real`` (one read of the
    lengths to the host), the rows past it zeroed, as the plain version."""
    out = torch.empty(qkv.shape[:2] + (qkv.shape[2] // 3,), dtype=qkv.dtype, device=qkv.device)
    for bi, n in enumerate(lengths.tolist()):
        out[bi: bi + 1] = launch(qkv[bi: bi + 1], n, rope)
        out[bi, n:] = 0
    return out


# ---- K1: exact two-pass softmax, whole score row per tile ----------------------

def fused_attention_packed_plain(qkv: torch.Tensor, heads: int, scale: float,
                                 s_real: int | torch.Tensor | None = None, rope=None,
                                 quant_out: bool = False):
    """K1's arithmetic in plain PyTorch (see :func:`_exact_softmax_plain`).
    With ``quant_out``, the TPU kernel's epilogue (attention.py:1018-1024):
    each token's float32 head outputs over all heads, ``amax = max(max|o|,
    1e-8)``, ``clip(round(o · (127/amax)))`` and ``amax · (1/127)`` — K6's
    quantize with no layernorm and no activation."""
    if not quant_out:
        return _exact_softmax_plain(qkv, heads, scale, s_real, rope)
    b, s, w3 = qkv.shape
    q, sc = rowquant_plain(_exact_softmax_f32(qkv, heads, scale, s_real, rope).reshape(
        b * s, w3 // 3))
    return q.reshape(b, s, w3 // 3), sc.reshape(b, s, 1)


# the packed entries of K1 and K4: qkv, out, dtype, B, S, s_real, w, heads,
# scale, cos, sin, scratch, stream (K5 adds its panel after the scale; the
# varlen entries the lengths' pointer before the stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_VARLEN_ARGTYPES = _ARGTYPES[:-1] + [ctypes.c_void_p, ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _cuda_build.load("packed_attention")
    if lib.packed_attention.argtypes is None:
        for fn in (lib.packed_attention, lib.packed_attention_f32out):
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
        lib.packed_attention_varlen.argtypes = _VARLEN_ARGTYPES
        lib.packed_attention_varlen.restype = ctypes.c_int
        lib.attention_unpacked.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.attention_unpacked.restype = ctypes.c_int
    return lib


def fused_attention_packed(qkv: torch.Tensor, heads: int, scale: float,
                           s_real: int | torch.Tensor | None = None, rope=None,
                           quant_out: bool = False):
    """Multi-head attention on the packed qkv tensor [B, S, 3w] → [B, S, w],
    or with ``quant_out`` → (int8 [B, S, w], float32 [B, S, 1] per-token
    scales).

    ``s_real``: keys at or beyond it are masked out of the softmax (rows
    there compute values nothing should read); or per-sequence lengths, an
    int32 tensor [B] (the module docstring), without ``quant_out``.
    ``rope``: (cos, sin) tables [S, d/2] rotating q and k inside the kernel,
    or None. ``quant_out``: the kernel writes its float32 head outputs and
    K6's quantize pass (no layernorm, no activation) turns each [w] token row
    into int8 and a scale; the call counts as one K1 launch and no K6
    launch."""
    if qkv.device.type == "cpu":
        return fused_attention_packed_plain(qkv, heads, scale, s_real, rope, quant_out)
    if not qkv.is_cuda:
        raise ValueError(f"fused_attention_packed: unsupported device {qkv.device}")
    lib = _lib()
    varlen = torch.is_tensor(s_real)
    if varlen and quant_out:
        raise ValueError("fused_attention_packed: quant_out takes no per-sequence lengths")
    if varlen and qkv.dtype == torch.float32:
        _check_packed("fused_attention_packed", qkv, heads, s_real, _DTYPE_CODE)
        return _per_sequence(lambda x, n, r: fused_attention_packed(x, heads, scale, n, r),
                             qkv, s_real, rope)
    if varlen:
        out = _launch_packed("fused_attention_packed", lib.packed_attention_varlen, qkv, heads,
                             scale, s_real, rope)
        fused_attention_packed.varlen_launches += 1
    elif quant_out:
        b, s, w3 = qkv.shape
        out32 = _launch_packed("fused_attention_packed", lib.packed_attention_f32out, qkv,
                               heads, scale, s_real, rope, out_dtype=torch.float32)
        q, sc = _rowquant_launch("fused_attention_packed", out32.view(b * s, w3 // 3), None,
                                 None, None, 1e-5)
        out = q.view(b, s, w3 // 3), sc.view(b, s, 1)
    else:
        out = _launch_packed("fused_attention_packed", lib.packed_attention, qkv, heads,
                             scale, s_real, rope)
    fused_attention_packed.launches += 1
    return out


fused_attention_packed.launches = 0
fused_attention_packed.varlen_launches = 0  # those of the launches with per-sequence lengths


# ---- K4: exact two-pass softmax, keys streamed (the head-grouped route) ---------

def fused_attention_packed_grouped_plain(qkv: torch.Tensor, heads: int, scale: float,
                                         s_real: int | None = None,
                                         rope=None) -> torch.Tensor:
    """K4's arithmetic in plain PyTorch: the TPU ``_packed_grouped_kernel``
    (attention.py:166-274) computes K1's function, grouped by heads only for
    its VMEM (see :func:`_exact_softmax_plain`)."""
    return _exact_softmax_plain(qkv, heads, scale, s_real, rope)


def _grouped_lib() -> ctypes.CDLL:
    lib = _cuda_build.load("packed_attention_grouped")
    if lib.packed_attention_grouped.argtypes is None:
        lib.packed_attention_grouped.argtypes = _ARGTYPES
        lib.packed_attention_grouped.restype = ctypes.c_int
    return lib


def fused_attention_packed_grouped(qkv: torch.Tensor, heads: int, scale: float,
                                   s_real: int | None = None, rope=None) -> torch.Tensor:
    """Multi-head attention on the packed qkv tensor [B, S, 3w] → [B, S, w]
    where the JAX package runs its head-grouped kernel (PE-Core-G14-448 in
    bf16; the float32 runs of the 336/384-pixel towers). Any S, head dim up
    to 128; ``s_real`` and ``rope`` as in :func:`fused_attention_packed`."""
    if qkv.device.type == "cpu":
        return fused_attention_packed_grouped_plain(qkv, heads, scale, s_real, rope)
    if not qkv.is_cuda:
        raise ValueError(f"fused_attention_packed_grouped: unsupported device {qkv.device}")
    if torch.is_tensor(s_real):
        raise ValueError("fused_attention_packed_grouped: per-sequence lengths run on K1 "
                         "(fused_attention_packed), which computes the same function")
    out = _launch_packed("fused_attention_packed_grouped",
                         _grouped_lib().packed_attention_grouped, qkv, heads, scale, s_real,
                         rope)
    fused_attention_packed_grouped.launches += 1
    return out


fused_attention_packed_grouped.launches = 0


# ---- K5: online softmax over k panels ---------------------------------------

def flash_attention_packed_plain(qkv: torch.Tensor, heads: int, scale: float,
                                 s_real: int | torch.Tensor | None = None,
                                 rope=None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (the JAX ``_flash_kernel``,
    attention.py:441-511): q·scale in the input dtype (the scale itself cast
    to it first), then, with ``rope``, q rotated and k rotated unscaled with
    the tables in the input dtype (K1's rotation, each key with its own
    rows); per k panel of :func:`flash_panel` keys
    ``m' = max(m, rowmax(s))``, ``α = exp(m − m')``, ``p = exp(s − m')``,
    ``l = l·α + Σp`` over the unrounded float32 p,
    ``acc = acc·α + T(p)·v``; at the end ``acc / l``. Per-sequence lengths
    ``s_real`` [B] mask each sequence's keys and zero its rows past them."""
    s = qkv.shape[1]
    s_real = s if s_real is None else s_real
    q, k, v = _split_heads(qkv, heads)
    q = q * torch.tensor(scale, dtype=qkv.dtype, device=qkv.device)
    cos, sin = _rope_tables("flash_attention_packed", qkv, heads, rope)
    if cos is not None:
        q, k = _rot_half(q, cos, sin), _rot_half(k, cos, sin)
    qf = q.float()
    shape = qf.shape[:-1] + (1,)
    m = torch.full(shape, float("-inf"), device=qkv.device)
    l = torch.zeros(shape, device=qkv.device)
    acc = torch.zeros(qf.shape, device=qkv.device)
    panel = flash_panel(s)
    for p0 in range(0, s, panel):
        p1 = min(p0 + panel, s)
        sc = torch.matmul(qf, k[:, :, p0:p1].float().transpose(-1, -2))
        if torch.is_tensor(s_real):
            sc = sc.masked_fill(_key_mask(s_real - p0, p1 - p0), float("-inf"))
        elif s_real < p1:
            sc[..., max(s_real - p0, 0):] = float("-inf")
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).float(), v[:, :, p0:p1].float())
        m = m_new
    return _merge_heads(_zero_past(acc / l, s_real).to(qkv.dtype))


def _flash_lib() -> ctypes.CDLL:
    lib = _cuda_build.load("flash_attention")
    if lib.flash_attention.argtypes is None:
        lib.flash_attention.argtypes = _ARGTYPES[:9] + [ctypes.c_int] + _ARGTYPES[9:]
        lib.flash_attention.restype = ctypes.c_int
        lib.flash_attention_varlen.argtypes = (_VARLEN_ARGTYPES[:9] + [ctypes.c_int]
                                               + _VARLEN_ARGTYPES[9:])
        lib.flash_attention_varlen.restype = ctypes.c_int
    return lib


def flash_attention_packed(qkv: torch.Tensor, heads: int, scale: float,
                           s_real: int | torch.Tensor | None = None, rope=None) -> torch.Tensor:
    """Online-softmax attention on the packed qkv tensor [B, S, 3w] → [B, S, w],
    rescaling at the JAX flash kernel's k-panel boundaries. ``rope``: (cos,
    sin) tables [S, d/2] rotating q and k inside the kernel, or None.
    ``s_real``: an int, or per-sequence lengths [B] (the module docstring)."""
    if qkv.device.type == "cpu":
        return flash_attention_packed_plain(qkv, heads, scale, s_real, rope)
    if not qkv.is_cuda:
        raise ValueError(f"flash_attention_packed: unsupported device {qkv.device}")
    varlen = torch.is_tensor(s_real)
    if varlen and qkv.dtype == torch.float32:
        _check_packed("flash_attention_packed", qkv, heads, s_real, _DTYPE_CODE)
        return _per_sequence(lambda x, n, r: flash_attention_packed(x, heads, scale, n, r),
                             qkv, s_real, rope)
    lib = _flash_lib()
    out = _launch_packed("flash_attention_packed",
                         lib.flash_attention_varlen if varlen else lib.flash_attention, qkv,
                         heads, scale, s_real, rope, panel=flash_panel(qkv.shape[1]))
    flash_attention_packed.launches += 1
    if varlen:
        flash_attention_packed.varlen_launches += 1
    if rope is not None:
        flash_attention_packed.rope_launches += 1
    return out


flash_attention_packed.launches = 0
flash_attention_packed.rope_launches = 0  # those of the launches with RoPE tables
flash_attention_packed.varlen_launches = 0  # those with per-sequence lengths


# ---- K10: K1's arithmetic on unpacked [B, h, S, d] q, k, v --------------------

def fused_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """The JAX ``_attn_kernel`` (attention.py:25-45) in plain PyTorch, on
    [B, h, S, d]: q·scale in q's dtype, float32 scores, float32 softmax
    statistics (keys past S masked: none here, the port does not pad), P cast
    to v's dtype before P·V, 1/sum applied after, the result in q's dtype —
    :func:`_exact_softmax_plain`'s arithmetic in the unpacked layout."""
    return _exact_heads_f32(q, k, v, scale, None).to(q.dtype)


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """softmax(q·kᵀ·scale)·v on q, k, v [B, h, S, d] (float32 or bfloat16,
    one dtype) → [B, h, S, d] of q's dtype, without a scores tensor in
    device memory: K1's kernels reading the three tensors in place."""
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale)
    if not q.is_cuda:
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if (t.dim() != 4 or t.shape != q.shape or t.dtype != q.dtype or t.device != q.device
                or t.dtype not in _DTYPE_CODE or not t.is_contiguous()):
            raise ValueError(
                f"fused_attention: {name} must be a contiguous [B, h, S, d] float32 or "
                f"bfloat16 tensor like q {tuple(q.shape)} {q.dtype}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}"
            )
    b, h, s, d = q.shape
    if d > 128:
        raise ValueError(f"fused_attention: head dim {d} is over 128")
    if q.dtype == torch.bfloat16 and (d % 8 or any(t.data_ptr() % 16 for t in (q, k, v))):
        raise ValueError("fused_attention: the bfloat16 kernel reads 16-byte vectors — head "
                         f"dim {d} must be a multiple of 8 and the data 16-byte aligned")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib().attention_unpacked(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _DTYPE_CODE[q.dtype], b,
            h, s, d, float(scale), torch.cuda.current_stream(q.device).cuda_stream,
        )
    _cuda_build.check(err, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


# ---- K3: the static-scale int8 attention wire --------------------------------

def fused_attention_packed_q8s_plain(qkv_q: torch.Tensor, ch_scale: torch.Tensor,
                                     heads: int, s_real: int | None = None) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (the JAX ``_packed_q8s_kernel``,
    attention.py:765-808): q, k, v become ``bf16(f32(int8)·cs)`` per channel
    (cs[:w] carries the attention scale, cs[2w:] the 127/attn_out_amax
    requantize), float32 scores with an exact -inf mask on keys ≥ s_real,
    exponentials against the final row max, the sum over the unrounded float32
    P, P cast to bf16 for P·V, the head output DIVIDED by the sum, then
    round half to even and clip to ±127."""
    s = qkv_q.shape[1]
    s_real = s if s_real is None else s_real
    deq = (qkv_q.float() * ch_scale.float()).to(torch.bfloat16)
    q, k, v = _split_heads(deq, heads)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if s_real < s:
        scores[..., s_real:] = float("-inf")
    probs = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    denom = probs.sum(dim=-1, keepdim=True)
    out = torch.matmul(probs.to(torch.bfloat16).float(), v.float()) / denom
    return _merge_heads(out.round_().clamp_(-127, 127).to(torch.int8))


def _q8s_lib() -> ctypes.CDLL:
    lib = _cuda_build.load("packed_attention_q8s")
    if lib.packed_attention_q8s.argtypes is None:
        lib.packed_attention_q8s.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.packed_attention_q8s.restype = ctypes.c_int
    return lib


def fused_attention_packed_q8s(qkv_q: torch.Tensor, ch_scale: torch.Tensor, heads: int,
                               s_real: int | None = None) -> torch.Tensor:
    """Static-wire attention: int8 qkv [B, S, 3w] with the pre-folded float32
    channel scales ``ch_scale`` [3w] → int8 [B, S, w] (dequant scale
    attn_out_amax/127, held by the caller)."""
    if qkv_q.device.type == "cpu":
        return fused_attention_packed_q8s_plain(qkv_q, ch_scale, heads, s_real)
    if not qkv_q.is_cuda:
        raise ValueError(f"fused_attention_packed_q8s: unsupported device {qkv_q.device}")
    b, s, w3 = qkv_q.shape
    s_real = s if s_real is None else s_real
    _check_packed("fused_attention_packed_q8s", qkv_q, heads, s_real, (torch.int8,))
    w = w3 // 3
    if (w // heads) % 8 or qkv_q.data_ptr() % 8:
        raise ValueError(
            "fused_attention_packed_q8s: the kernel reads 8-byte vectors — head dim "
            f"{w // heads} must be a multiple of 8 and the data 8-byte aligned"
        )
    if (ch_scale.device != qkv_q.device or ch_scale.dtype != torch.float32
            or ch_scale.numel() != w3 or not ch_scale.is_contiguous()):
        raise ValueError(
            f"fused_attention_packed_q8s: ch_scale must be a contiguous float32 tensor of "
            f"{w3} elements on {qkv_q.device}, got {tuple(ch_scale.shape)} "
            f"{ch_scale.dtype} on {ch_scale.device}"
        )
    out = torch.empty((b, s, w), dtype=torch.int8, device=qkv_q.device)
    with torch.cuda.device(qkv_q.device):
        err = _q8s_lib().packed_attention_q8s(
            qkv_q.data_ptr(), ch_scale.data_ptr(), out.data_ptr(), b, s, s_real, w, heads,
            torch.cuda.current_stream(qkv_q.device).cuda_stream,
        )
    _cuda_build.check(err, "packed_attention_q8s")
    fused_attention_packed_q8s.launches += 1
    return out


fused_attention_packed_q8s.launches = 0


# ---- K7: int8 qkv with per-token scales ---------------------------------------

def fused_attention_packed_q8_plain(qkv_q: torch.Tensor, qkv_scale: torch.Tensor, heads: int,
                                    scale: float, out_dtype=torch.bfloat16,
                                    quant_out: bool = False, s_real: int | None = None):
    """The kernel's arithmetic in plain PyTorch (the JAX ``_packed_q8_kernel``,
    attention.py:619-666): with rs the token's float32 scale, q =
    ``bf16(f32(int8)·(rs·scale))`` (rs·scale formed first), k and v =
    ``bf16(f32(int8)·rs)``, then K1's exact softmax on those bf16 heads at
    scale 1 (float32 scores, the −inf mask on keys ≥ s_real, P cast to bf16,
    1/sum after P·V). The result in ``out_dtype``, or with ``quant_out`` int8
    and a float32 [B, S, 1] scale from the amax over each token's whole [w]
    row (K6's quantize). Not ``attention_packed_q8_xla``, which folds the
    scale in another order (attention.py:729-733)."""
    b, s, w3 = qkv_q.shape
    w = w3 // 3
    rs = qkv_scale.float().reshape(b, s, 1)
    f = qkv_q.float()
    deq = torch.cat([(f[..., :w] * (rs * scale)).to(torch.bfloat16),
                     (f[..., w:] * rs).to(torch.bfloat16)], dim=-1)
    out = _exact_softmax_f32(deq, heads, 1.0, s_real, None)
    if not quant_out:
        return out.to(out_dtype)
    q, sc = rowquant_plain(out.reshape(b * s, w))
    return q.reshape(b, s, w), sc.reshape(b, s, 1)


def _q8_lib() -> ctypes.CDLL:
    lib = _cuda_build.load("packed_attention_q8")
    if lib.packed_attention_q8.argtypes is None:
        lib.packed_attention_q8.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_void_p,
        ]
        lib.packed_attention_q8.restype = ctypes.c_int
    return lib


def fused_attention_packed_q8(qkv_q: torch.Tensor, qkv_scale: torch.Tensor, heads: int,
                              scale: float, out_dtype=torch.bfloat16, quant_out: bool = False,
                              s_real: int | None = None):
    """Attention on int8 packed qkv [B, S, 3w] with float32 per-token scales
    [B, S, 1] → [B, S, w] of ``out_dtype`` (bfloat16 or float32), or with
    ``quant_out`` → (int8 [B, S, w], float32 [B, S, 1]): the kernel writes
    its float32 head outputs and K6's quantize pass turns each [w] token row
    into int8 and a scale, one K7 launch and no K6 launch."""
    if qkv_q.device.type == "cpu":
        return fused_attention_packed_q8_plain(qkv_q, qkv_scale, heads, scale, out_dtype,
                                               quant_out, s_real)
    if not qkv_q.is_cuda:
        raise ValueError(f"fused_attention_packed_q8: unsupported device {qkv_q.device}")
    b, s, w3 = qkv_q.shape
    s_real = s if s_real is None else s_real
    _check_packed("fused_attention_packed_q8", qkv_q, heads, s_real, (torch.int8,))
    w = w3 // 3
    if (w // heads) % 8 or qkv_q.data_ptr() % 8:
        raise ValueError(
            "fused_attention_packed_q8: the kernel reads 8-byte vectors — head dim "
            f"{w // heads} must be a multiple of 8 and the data 8-byte aligned"
        )
    if (qkv_scale.device != qkv_q.device or qkv_scale.dtype != torch.float32
            or qkv_scale.numel() != b * s or not qkv_scale.is_contiguous()):
        raise ValueError(
            f"fused_attention_packed_q8: qkv_scale must be a contiguous float32 [{b}, {s}, 1] "
            f"tensor on {qkv_q.device}, got {tuple(qkv_scale.shape)} {qkv_scale.dtype} on "
            f"{qkv_scale.device}"
        )
    if out_dtype not in _DTYPE_CODE:
        raise ValueError(f"fused_attention_packed_q8: out_dtype float32 or bfloat16, got "
                         f"{out_dtype}")
    out = torch.empty((b, s, w), dtype=torch.float32 if quant_out else out_dtype,
                      device=qkv_q.device)
    with torch.cuda.device(qkv_q.device):
        err = _q8_lib().packed_attention_q8(
            qkv_q.data_ptr(), qkv_scale.data_ptr(), out.data_ptr(), _DTYPE_CODE[out.dtype], b,
            s, s_real, w, heads, float(scale), torch.cuda.current_stream(qkv_q.device).cuda_stream,
        )
    _cuda_build.check(err, "packed_attention_q8")
    if quant_out:
        q, sc = _rowquant_launch("fused_attention_packed_q8", out.view(b * s, w), None, None,
                                 None, 1e-5)
        out = q.view(b, s, w), sc.view(b, s, 1)
    fused_attention_packed_q8.launches += 1
    return out


fused_attention_packed_q8.launches = 0
