"""Wrapper of the paged flash-decode kernel (model layout).

On a CUDA tensor it launches ``csrc/paged_decode.cu`` (or raises); on a
CPU tensor it runs the plain version (``ref.paged_decode_ref``, or
``ref.paged_decode_int8_ref`` for int8 pages). There is no fallback from
one to the other. ``launches`` counts launches of the bf16/f32 mode,
``int8_launches`` those of the int8 mode.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention.ref import (paged_decode_int8_ref,
                                                      paged_decode_ref)

SPLIT_TOKENS = 256   # tokens per CTA of pass 1 (one page at the path's
                     # shapes)
MAX_GROUP = 8        # query heads per kv head the kernel takes

launches = 0
int8_launches = 0


def split_count(smax: int) -> int:
    """Pass-1 CTAs per (slot, kv head) for a cache of ``smax`` tokens."""
    return -(-smax // SPLIT_TOKENS)


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, kv_len: torch.Tensor = None, *,
                 logit_softcap: float = 0.0, k_scale: torch.Tensor = None,
                 v_scale: torch.Tensor = None, new_k: torch.Tensor = None,
                 new_v: torch.Tensor = None,
                 pos: torch.Tensor = None) -> torch.Tensor:
    """q: [B,1,H,D]; pages [B,P,page,Hkv,D]; kv_len int32 [B] -> [B,1,H,D].

    Row b attends to its first ``min(kv_len[b], P*page)`` positions.
    With ``k_scale`` the int8 mode runs instead (``_paged_decode_int8``).
    """
    global launches
    if k_scale is not None:
        if kv_len is not None:
            raise ValueError("the int8 mode takes pos, not kv_len")
        return _paged_decode_int8(q, k_pages, v_pages, k_scale, v_scale,
                                  new_k, new_v, pos, logit_softcap)
    if q.dim() != 4 or q.shape[1] != 1 or k_pages.dim() != 5:
        raise ValueError(f"expected q [B,1,H,D] and pages [B,P,page,Hkv,D], "
                         f"got {tuple(q.shape)} / {tuple(k_pages.shape)}")
    b, _, h, d = q.shape
    _, p, page, hkv, dk = k_pages.shape
    if (k_pages.shape != v_pages.shape or k_pages.shape[0] != b or dk != d
            or h % hkv or kv_len.shape != (b,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, pages "
                         f"{tuple(k_pages.shape)}/{tuple(v_pages.shape)}, "
                         f"kv_len {tuple(kv_len.shape)}")
    if not (q.dtype == k_pages.dtype == v_pages.dtype):
        raise TypeError("q and the pages must share one dtype")
    devices = {q.device, k_pages.device, v_pages.device, kv_len.device}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    if q.device.type == "cpu":
        return paged_decode_ref(q, k_pages, v_pages, kv_len, logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if kv_len.dtype != torch.int32:
        raise TypeError("kv_len must be int32")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"at most {MAX_GROUP} query heads per kv head")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("kv_len", kv_len)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    smax = p * page
    n_splits = split_count(smax)
    g = h // hkv
    out = torch.empty_like(q)
    part_acc = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hkv, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    lib = build.library()
    rc = lib.repro_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), b, h, hkv, smax, d, SPLIT_TOKENS, n_splits,
        build.DTYPE_CODES[q.dtype], 1.0 / (d ** 0.5), float(logit_softcap),
        build.stream_ptr(q.device))
    launches += 1
    build.check(rc, "paged_decode")
    return out


def _paged_decode_int8(q, k_codes, v_codes, k_scale, v_scale, new_k, new_v,
                       pos, logit_softcap):
    """The int8 mode. Codes int8 [B,P,page,Hkv,D] and f32 scales
    [B,P,Hkv] are read in place (code x its page's scale); the new token's
    K/V [B,1,Hkv,D] (q's dtype) stands at ``min(pos[b], P*page - 1)`` in
    place of that row's code, at full precision, and row b attends over
    ``[0, pos[b]]``. Nothing is written to the pages: the caller
    requantizes the page it wrote (``models.attention``)."""
    global int8_launches
    if q.dim() != 4 or q.shape[1] != 1 or k_codes.dim() != 5:
        raise ValueError(f"expected q [B,1,H,D] and codes [B,P,page,Hkv,D]"
                         f", got {tuple(q.shape)} / {tuple(k_codes.shape)}")
    b, _, h, d = q.shape
    _, p, page, hkv, dk = k_codes.shape
    if any(t is None for t in (v_scale, new_k, new_v, pos)):
        raise ValueError("the int8 mode needs k_scale, v_scale, new_k, "
                         "new_v and pos")
    if (k_codes.shape != v_codes.shape or k_codes.shape[0] != b or dk != d
            or h % hkv or k_scale.shape != (b, p, hkv)
            or v_scale.shape != (b, p, hkv)
            or new_k.shape != (b, 1, hkv, d)
            or new_v.shape != (b, 1, hkv, d) or pos.shape != (b,)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, codes "
                         f"{tuple(k_codes.shape)}/{tuple(v_codes.shape)}, "
                         f"scales {tuple(k_scale.shape)}/"
                         f"{tuple(v_scale.shape)}, new "
                         f"{tuple(new_k.shape)}/{tuple(new_v.shape)}, pos "
                         f"{tuple(pos.shape)}")
    if not (k_codes.dtype == v_codes.dtype == torch.int8):
        raise TypeError("the int8 mode takes int8 codes")
    if not (k_scale.dtype == v_scale.dtype == torch.float32):
        raise TypeError("the scales must be float32")
    if not (q.dtype == new_k.dtype == new_v.dtype):
        raise TypeError("q and the new K/V must share one dtype")
    inputs = (("q", q), ("k_codes", k_codes), ("v_codes", v_codes),
              ("k_scale", k_scale), ("v_scale", v_scale), ("new_k", new_k),
              ("new_v", new_v), ("pos", pos))
    devices = {t.device for _, t in inputs}
    if len(devices) != 1:
        raise ValueError(f"inputs span devices {devices}")
    if q.device.type == "cpu":
        return paged_decode_int8_ref(q, k_codes, v_codes, k_scale, v_scale,
                                     new_k, new_v, pos, logit_softcap)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise TypeError(f"unsupported dtype {q.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError("pos must be int32")
    if h // hkv > MAX_GROUP:
        raise ValueError(f"at most {MAX_GROUP} query heads per kv head")
    for name, t in inputs:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    smax = p * page
    n_splits = split_count(smax)
    g = h // hkv
    out = torch.empty_like(q)
    part_acc = torch.empty((b, hkv, n_splits, g, d), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((b, hkv, n_splits, g, 2), dtype=torch.float32,
                          device=q.device)
    lib = build.library()
    rc = lib.repro_paged_decode_int8(
        q.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), new_k.data_ptr(),
        new_v.data_ptr(), pos.data_ptr(), out.data_ptr(), part_acc.data_ptr(),
        part_ml.data_ptr(), b, h, hkv, smax, page, d, SPLIT_TOKENS, n_splits,
        build.DTYPE_CODES[q.dtype], 1.0 / (d ** 0.5), float(logit_softcap),
        build.stream_ptr(q.device))
    int8_launches += 1
    build.check(rc, "paged_decode_int8")
    return out
