"""Entry point of the flash attention kernel (B5), with its plain version
and a launch counter.

`flash_attention` keeps the model layout (B, S, H, D) at its public face,
as the reference's `flash_attn/ops.py` does: q (B, Sq, H, D), k and v
(B, Sk, KV, D), GQA by query head h -> kv head h // (H / KV), causal and
sliding-window masks, a tanh logit cap, and a `kv_len` bound on the valid
keys.  Scores, softmax and the accumulator are f32; the output has q's
type.  On CUDA tensors it launches a hand-written kernel that reads the
model layout through its strides (no transpose): for bfloat16, the wgmma
kernel fed by TMA in csrc/flash_attn_sm90.cu, which pads D = 80 to 128 in
shared memory and needs each of q, k and v to have a 16-byte-aligned base
and strides on B, S and H that are multiples of 8 elements (else it
raises); for float32, the SIMT kernel in csrc/flash_attn.cu.  On CPU
tensors it runs `flash_attention_plain`.  There is no fallback: a CUDA
tensor launches a kernel or raises.  Inputs that are not tensors go to ``device``, which
defaults to the CUDA device.

`LAUNCHES["flash_attn"]` counts kernel launches; the launcher in kernel.py
adds one after each launch that succeeded and nowhere else (an empty
output launches nothing and counts nothing).
"""
from __future__ import annotations

import torch

from repro_torch._util import resolve_device
from repro_torch.kernels.flash_attn.ref import attention_ref

LAUNCHES = {"flash_attn": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True, window: int | None = None,
    logit_cap: float | None = None, kv_len: int | None = None,
) -> torch.Tensor:
    """The kernel's function in dense form, in the model layout."""
    out = attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        causal=causal, window=window, logit_cap=logit_cap, kv_len=kv_len)
    return out.transpose(1, 2)


def flash_attention(
    q, k, v, *,
    causal: bool = True,
    window: int | None = None,
    logit_cap: float | None = None,
    kv_len: int | None = None,
    device: str | torch.device | None = None,
) -> torch.Tensor:
    """q (B, Sq, H, D), k/v (B, Sk, KV, D) -> (B, Sq, H, D) in q's type."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        device = resolve_device(device)
        q, k, v = (torch.as_tensor(t, device=device) for t in (q, k, v))
    cuda = {t.is_cuda for t in (q, k, v)}
    if len(cuda) != 1:
        raise ValueError("flash_attention inputs mix CUDA and CPU tensors")
    if not cuda.pop():
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     logit_cap=logit_cap, kv_len=kv_len)
    from repro_torch.kernels.flash_attn import kernel

    return kernel.flash_attn(q, k, v, causal=causal, window=window,
                             logit_cap=logit_cap, kv_len=kv_len)
