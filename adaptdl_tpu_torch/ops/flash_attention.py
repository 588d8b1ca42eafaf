"""Flash attention: hand-written Hopper kernels for the attention hot loop.

The forward ports the Pallas TPU kernel
``adaptdl_tpu/ops/flash_attention.py::_fwd_kernel``: exact blockwise
attention with an online softmax in f32, so the ``[seq, seq]`` score
matrix never reaches device memory, plus the per-row log-sum-exp the
backward reads. Two CUDA kernels compute it; :func:`forward_kernel`
picks one from the dtype and head_dim before the launch:

- ``csrc/flash_attention_fwd_sm90.cu`` for bfloat16 with head_dim 64 or
  128: bf16 ``wgmma`` on the tensor cores, K/V staged by TMA.
- ``csrc/flash_attention_fwd.cu`` for float32 and the other head dims
  (multiples of 8 up to 128): TF32 ``mma.sync`` on the tensor cores,
  each product split in three (3xTF32) so the result stays float32.

Each kernel's note says what bounds it on the H100 and how its design
answers that.

Beside the kernels, in this module:

- :func:`flash_attention_reference`, the plain PyTorch version of the
  same function: a blockwise online-softmax loop with the kernels'
  ``block_q``/``block_k`` contract (seq must divide by both). The
  wrapper takes it for CPU tensors only; for a CUDA tensor it launches
  a kernel or raises.
- :func:`flash_attention_backward`, the blockwise recompute backward of
  ``_flash_vjp_bwd`` (plain JAX there, plain PyTorch here): P is rebuilt
  from the saved log-sum-exp, ``delta = rowsum(dO * O)``, and
  ``dV = P^T dO``, ``dS = P * (dO V^T - delta)``, ``dQ = dS K * scale``,
  ``dK = dS^T Q * scale``.
- :func:`flash_attention`, the differentiable entry point over
  ``[batch, heads, seq, head_dim]``, usable as the transformer's
  ``attention_fn``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.profiler import record_function

from adaptdl_tpu_torch.ops import _build

NEG_INF = -1e30
KERNEL = "flash_attention_fwd"  # f32 and bf16, head_dim 8..128 by 8
KERNEL_SM90 = "flash_attention_fwd_sm90"  # bf16 wgmma, head_dim 64/128
SM90_HEAD_DIMS = (64, 128)
RANGE_BACKWARD = "adaptdl.flash_backward"  # profiler range of the backward
MAX_HEAD_DIM = 128
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _resolve_scale(head_dim: int, scale: float | None) -> float:
    return head_dim**-0.5 if scale is None else float(scale)


def _check_blocks(seq: int, block_q: int, block_k: int) -> tuple[int, int]:
    block_q = min(block_q, seq)
    block_k = min(block_k, seq)
    if seq % block_q or seq % block_k:
        raise ValueError(
            f"seq_len {seq} must divide into blocks ({block_q}, {block_k})"
        )
    return block_q, block_k


def flash_attention_reference(
    q, k, v, causal: bool = True, scale: float | None = None,
    block_q: int = 128, block_k: int = 128,
):
    """Plain forward over ``[bh, seq, d]``: ``(out in q's dtype, lse f32
    [bh, seq])``. Query blocks stream past key blocks with a running
    (max, sum, accumulator) triple; key blocks wholly above the causal
    diagonal are skipped."""
    bh, seq, head_dim = q.shape
    block_q, block_k = _check_blocks(seq, block_q, block_k)
    scale = _resolve_scale(head_dim, scale)
    q32 = q.float() * scale
    k32 = k.float()
    v32 = v.float()
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q.device)
    for qs in range(0, seq, block_q):
        q_blk = q32[:, qs : qs + block_q]
        m = torch.full((bh, block_q, 1), NEG_INF, device=q.device)
        l = torch.zeros((bh, block_q, 1), device=q.device)
        acc = torch.zeros((bh, block_q, head_dim), device=q.device)
        for ks in range(0, seq, block_k):
            if causal and ks > qs + block_q - 1:
                break
            s = q_blk @ k32[:, ks : ks + block_k].transpose(1, 2)
            if causal:
                q_pos = qs + torch.arange(block_q, device=q.device)
                k_pos = ks + torch.arange(block_k, device=q.device)
                s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
            m_next = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_next)
            rescale = torch.exp(m - m_next)
            l = l * rescale + p.sum(dim=-1, keepdim=True)
            acc = acc * rescale + p @ v32[:, ks : ks + block_k]
            m = m_next
        safe_l = torch.clamp(l, min=1e-30)
        out[:, qs : qs + block_q] = (acc / safe_l).to(q.dtype)
        lse[:, qs : qs + block_q] = (m + torch.log(safe_l))[..., 0]
    return out, lse


def forward_kernel(dtype: torch.dtype, head_dim: int) -> str:
    """Name of the CUDA kernel that computes the forward for inputs of
    ``dtype`` and ``head_dim`` (its key in ``_build.LAUNCHES``)."""
    if dtype == torch.bfloat16 and head_dim in SM90_HEAD_DIMS:
        return KERNEL_SM90
    return KERNEL


def _kernel_entry(name: str):
    """The C entry point of kernel ``name``, its library built and
    loaded on first use. Both take (q, k, v, o, lse, bh, seq, head_dim,
    [dtype code,] causal, scale, stream); only ``flash_attention_fwd.cu``
    takes the dtype code."""
    lib = _build.load(name)
    fn = getattr(lib, f"adaptdl_{name}")
    if fn.argtypes is None:
        ints = 4 if name == KERNEL_SM90 else 5
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * ints + [
            ctypes.c_float, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib, fn


def _launch(name, q, k, v, causal, scale):
    """Launch kernel ``name`` on CUDA tensors and count the launch.
    :func:`flash_attention_fwd` reaches it through :func:`forward_kernel`;
    the card's checks call it directly to time either kernel on the same
    inputs."""
    bh, seq, head_dim = q.shape
    if name == KERNEL_SM90 and (
        q.dtype != torch.bfloat16 or head_dim not in SM90_HEAD_DIMS
    ):
        raise ValueError(
            f"{KERNEL_SM90} takes bfloat16 with head_dim in "
            f"{SM90_HEAD_DIMS}, not {q.dtype} with head_dim {head_dim}"
        )
    lib, fn = _kernel_entry(name)
    out = torch.empty_like(q)
    lse = torch.empty((bh, seq), dtype=torch.float32, device=q.device)
    dtype_code = () if name == KERNEL_SM90 else (_KERNEL_DTYPES[q.dtype],)
    with torch.cuda.device(q.device):
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, seq, head_dim, *dtype_code, int(causal),
            _resolve_scale(head_dim, scale),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _build.check(lib, err, name)
    _build.LAUNCHES[name] += 1
    return out, lse


def flash_attention_fwd(
    q, k, v, causal: bool = True, scale: float | None = None,
    block_q: int = 128, block_k: int = 128,
):
    """``(out, lse)`` for ``[bh, seq, d]`` inputs: a CUDA kernel for
    CUDA tensors (:func:`forward_kernel` says which), the plain version
    for CPU tensors.

    The kernels tile by their own blocks; ``block_q``/``block_k`` keep
    the TPU kernel's contract (seq divides by both) on every device so a
    configuration valid here is valid everywhere.
    """
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(
            "q, k, v must share one [bh, seq, head_dim] shape; got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("q, k, v must share one dtype")
    bh, seq, head_dim = q.shape
    _check_blocks(seq, block_q, block_k)
    if q.device.type == "cpu":
        return flash_attention_reference(
            q, k, v, causal, scale, block_q, block_k
        )
    if q.device.type != "cuda":
        raise ValueError(
            f"flash_attention_fwd takes CUDA or CPU tensors, not {q.device}"
        )
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(
            f"the CUDA kernel takes float32 or bfloat16, not {q.dtype}"
        )
    if head_dim % 8 or not 8 <= head_dim <= MAX_HEAD_DIM:
        raise ValueError(
            f"the CUDA kernel takes head_dim a multiple of 8 up to "
            f"{MAX_HEAD_DIM}, not {head_dim}"
        )
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return _launch(forward_kernel(q.dtype, head_dim), q, k, v, causal, scale)


def flash_attention_backward(
    q, k, v, out, lse, grad, causal: bool, scale: float | None,
    block_k: int,
):
    """``(dq, dk, dv)`` by blockwise recompute over key blocks."""
    bh, seq, head_dim = q.shape
    scale = _resolve_scale(head_dim, scale)
    block = min(block_k, seq)
    q32 = q.float() * scale
    k32 = k.float()
    v32 = v.float()
    g32 = grad.float()
    # delta_i = sum_d dO_id * O_id (the softmax-jacobian row term)
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    q_pos = torch.arange(seq, device=q.device)
    dq = torch.zeros_like(q32)
    dk = torch.empty_like(k32)
    dv = torch.empty_like(v32)
    for start in range(0, seq, block):
        k_blk = k32[:, start : start + block]
        v_blk = v32[:, start : start + block]
        s = q32 @ k_blk.transpose(1, 2)
        if causal:
            k_pos = start + torch.arange(block, device=q.device)
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        p = torch.exp(s - lse[..., None])
        ds = p * (g32 @ v_blk.transpose(1, 2) - delta)
        dv[:, start : start + block] = p.transpose(1, 2) @ g32
        dk[:, start : start + block] = ds.transpose(1, 2) @ q32  # scale in q32
        dq += (ds @ k_blk) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_q, block_k):
        out, lse = flash_attention_fwd(q, k, v, causal, scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        ctx.block_k = block_k
        return out

    @staticmethod
    def backward(ctx, grad):
        q, k, v, out, lse = ctx.saved_tensors
        with record_function(RANGE_BACKWARD):
            dq, dk, dv = flash_attention_backward(
                q, k, v, out, lse, grad, ctx.causal, ctx.scale, ctx.block_k
            )
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q, k, v, causal: bool = True, scale: float | None = None,
    block_q: int = 128, block_k: int = 128,
):
    """Blockwise exact attention over ``[batch, heads, seq, head_dim]``;
    returns the same shape in q's dtype."""
    batch, heads, seq, head_dim = q.shape

    def flat(x):
        return x.reshape(batch * heads, seq, head_dim).contiguous()

    out = _FlashAttention.apply(
        flat(q), flat(k), flat(v), causal, scale, block_q, block_k
    )
    return out.reshape(batch, heads, seq, head_dim)


def make_flash_attention(
    causal: bool = True, block_q: int = 128, block_k: int = 128
):
    """``attn(q, k, v) -> out`` for ``TransformerConfig.attention_fn``."""
    return functools.partial(
        flash_attention, causal=causal, block_q=block_q, block_k=block_k
    )
