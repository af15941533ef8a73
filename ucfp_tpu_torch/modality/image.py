"""Image modality pipeline: decode -> preprocess -> device hash -> Record.

Port of ucfp_tpu/modality/image.py for the perceptual hashes:
  * fingerprint_multi   -> 536-byte multi bundle   (algorithm "multi")
  * fingerprint_single  -> 8-byte phash/dhash/ahash
  * fingerprint_batch   -> multi bundles for same-shape decoded images

  * fingerprint_semantic -> 512-d embedding record ("embedding-image-local")
  * inspect_image        -> the per-stage view of the multi bundle

Decode and the exact fixed-point host resize are host code, copied from
the reference (byte-identical); everything after the luma plane runs in
ops.imagehash on the device named by `device` (the CUDA card unless the
caller asks for the CPU). The semantic path's exact-int 32x32 features
are host numpy, and the stand-in image MLP (models.encoders) runs on the
same device.
"""

from __future__ import annotations

import io
from dataclasses import dataclass

import numpy as np

from ..core import Modality, ModalityError, Record
from ..ops import imagehash
from .confighash import config_hash64

ALGORITHM_MULTI = "imgfprint-multi-v1"
ALGORITHM_PHASH = "imgfprint-phash-v1"
ALGORITHM_DHASH = "imgfprint-dhash-v1"
ALGORITHM_AHASH = "imgfprint-ahash-v1"
ALGORITHM_SEMANTIC = "embedding-image-local"


@dataclass(frozen=True)
class PreprocessConfig:
    """Validation + pre-resize config (manifest defaults)."""

    max_input_bytes: int = 50 * 1024 * 1024
    max_dimension: int = 8192
    min_dimension: int = 32

    def config_hash(self) -> int:
        return config_hash64(
            "image-preprocess",
            max_input_bytes=self.max_input_bytes,
            max_dimension=self.max_dimension,
            min_dimension=self.min_dimension,
        )


def _fast_bmp_view(data: bytes):
    """Header parse + strided view for plain 24-bit uncompressed BMPs.

    Returns (bgr_view [rows, w, 3] in STORED row order, bottom_up) or
    None for anything but BI_RGB 24bpp, so every other BMP flavor falls
    through to PIL. The view aliases `data`."""
    import struct

    if len(data) < 54 or data[:2] != b"BM":
        return None
    off = struct.unpack_from("<I", data, 10)[0]
    hsz = struct.unpack_from("<I", data, 14)[0]
    if hsz < 40:  # BITMAPCOREHEADER layouts differ; let PIL handle them
        return None
    w, h = struct.unpack_from("<ii", data, 18)
    bpp = struct.unpack_from("<H", data, 28)[0]
    comp = struct.unpack_from("<I", data, 30)[0]
    if comp != 0 or bpp != 24 or w <= 0 or h == 0:
        return None
    rows = abs(h)
    stride = (w * 3 + 3) // 4 * 4
    if off + stride * rows > len(data):
        return None
    a = np.frombuffer(data, np.uint8, stride * rows, off)
    a = a.reshape(rows, stride)[:, : w * 3].reshape(rows, w, 3)
    return a, h > 0  # bottom-up storage is the common case


def _fast_bmp_rgb(data: bytes):
    """Numpy decode for plain 24-bit uncompressed BMPs, byte-identical to
    PIL's."""
    fv = _fast_bmp_view(data)
    if fv is None:
        return None
    a, bottom_up = fv
    if bottom_up:
        a = a[::-1]
    return np.ascontiguousarray(a[..., ::-1])  # BGR -> RGB


def decode_rgb(data: bytes, pre: PreprocessConfig) -> np.ndarray:
    """Decode image bytes to RGB uint8 [H, W, 3], enforcing preprocess limits."""
    try:
        from PIL import Image
    except ImportError as e:  # pragma: no cover
        raise ModalityError(f"image decode unavailable: {e}")

    if len(data) > pre.max_input_bytes:
        raise ModalityError(
            f"image exceeds max_input_bytes ({len(data)} > {pre.max_input_bytes})"
        )
    fast = _fast_bmp_rgb(data)
    if fast is not None:
        h, w = fast.shape[:2]
        if min(h, w) >= pre.min_dimension and max(h, w) <= pre.max_dimension:
            return fast
        # out-of-bounds dims re-run the PIL path for identical errors
        # and the identical pre-shrink resample
    try:
        img = Image.open(io.BytesIO(data))
        img.load()
    except Exception as e:
        raise ModalityError(f"image decode: {e}")
    if img.mode != "RGB":
        img = img.convert("RGB")
    arr = np.asarray(img, dtype=np.uint8)
    h, w = arr.shape[:2]
    if min(h, w) < pre.min_dimension:
        raise ModalityError(
            f"image too small: {w}x{h} < min_dimension {pre.min_dimension}"
        )
    if max(h, w) > pre.max_dimension:
        # oversized inputs pre-shrink with PIL's bilinear resize before
        # the exact hash-stage resizes (which always run)
        scale = pre.max_dimension / max(h, w)
        nh = max(1, round(h * scale))
        nw = max(1, round(w * scale))
        if min(nh, nw) < pre.min_dimension:
            raise ModalityError(
                f"image aspect ratio too extreme: downscaling {w}x{h} to the "
                f"max_dimension {pre.max_dimension} leaves the short edge "
                f"below min_dimension {pre.min_dimension}"
            )
        shrunk = Image.fromarray(arr, "RGB").resize(
            (nw, nh), Image.Resampling.BILINEAR
        )
        arr = np.asarray(shrunk, dtype=np.uint8)
    return arr


def decode_gray(data: bytes, pre: PreprocessConfig) -> np.ndarray:
    """Decode image bytes straight to BT.601 luma [H, W] uint8.

    Fast BMPs compute the exact np_luma_u8 formula on the strided BGR view;
    everything else is np_luma_u8(decode_rgb(data, pre)) — bit-identical
    either way."""
    if len(data) <= pre.max_input_bytes:
        fv = _fast_bmp_view(data)
        if fv is not None:
            a, bottom_up = fv
            h, w = a.shape[:2]
            if min(h, w) >= pre.min_dimension and max(h, w) <= pre.max_dimension:
                # stored order is BGR: weights indexed accordingly
                r = a[..., 2].astype(np.int32)
                g = a[..., 1].astype(np.int32)
                b = a[..., 0].astype(np.int32)
                out = ((299 * r + 587 * g + 114 * b + 500) // 1000).astype(
                    np.uint8
                )
                return out[::-1] if bottom_up else out
    return imagehash.np_luma_u8(decode_rgb(data, pre))


def decode_gray_batch(raw: bytes, max_n: int, pre: PreprocessConfig):
    """Whole-batch native decode for the image batch route framing
    ([u64 rid][u32 len][bytes]*). Returns (code, rids, gray):
      code 0  — rids list[int], gray uint8 [n, h, w], byte-identical to
                per-image decode_gray;
      code 1  — take the per-image Python path (native module unavailable,
                mixed shapes, non-BMP frames, frames outside the limits);
      code -1 / -2 / -3 — truncated frame header / body / more than max_n.
    """
    import ctypes

    from .. import native

    lib = native.load_imgbatch()
    if lib is None or not raw:
        return 1, None, None
    n = ctypes.c_int()
    h = ctypes.c_int()
    w = ctypes.c_int()
    code = lib.ucfp_imgbatch_probe(
        raw, len(raw), max_n, pre.min_dimension, pre.max_dimension,
        pre.max_input_bytes, ctypes.byref(n), ctypes.byref(h),
        ctypes.byref(w),
    )
    if code != 0:
        return code, None, None
    rids = np.empty(n.value, np.uint64)
    gray = np.empty((n.value, h.value, w.value), np.uint8)
    got = lib.ucfp_imgbatch_fill(
        raw, len(raw),
        rids.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n.value, h.value, w.value,
    )
    if got != n.value:  # pragma: no cover - probe/fill see the same bytes
        return 1, None, None
    return 0, rids.tolist(), gray


#: per-algorithm resized luma shape (rows, cols) — the hash stage's own
#: first-stage output, so shipping it pre-resized is byte-identical
SINGLE_HASH_INPUT = {"phash": (32, 32), "dhash": (8, 9), "ahash": (8, 8)}


def resize_gray_batch(gray: np.ndarray, oh: int, ow: int) -> np.ndarray:
    """Host exact fixed-point tent resize over a luma batch:
    [n, H, W] uint8 -> [n, oh, ow] uint8, byte-identical to the device
    resize_exact stage (native imgbatch, numpy fallback below)."""
    import ctypes

    from .. import native

    n, ih, iw = gray.shape
    wh = imagehash.resize_matrix_q(ih, oh)
    ww = imagehash.resize_matrix_q(iw, ow)
    lib = native.load_imgbatch()
    if lib is not None and n:
        if not gray.flags.c_contiguous:
            gray = np.ascontiguousarray(gray)
        out = np.empty((n, oh, ow), np.uint8)
        rc = lib.ucfp_imgbatch_resize(
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            n, ih, iw,
            wh.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), oh,
            ww.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), ow,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        if rc == 0:
            return out
    # numpy fallback: the identical two-stage integer matmul
    t = (np.einsum("oh,bhw->bow", wh.astype(np.int64),
                   gray.astype(np.int64))
         + imagehash.RESIZE_ROUND) >> imagehash.RESIZE_SHIFT
    o = (np.einsum("bow,pw->bop", t, ww.astype(np.int64))
         + imagehash.RESIZE_ROUND) >> imagehash.RESIZE_SHIFT
    return o.astype(np.uint8)


#: the four planes the multi bundle derives from; total 5,256 B/image —
#: shipping them pre-resized beats the full luma plane above this size
MULTI_PRE_PLANES = ((32, 32), (8, 9), (8, 8), (64, 64))
MULTI_PRE_THRESHOLD = 2 * sum(h * w for h, w in MULTI_PRE_PLANES)


def multi_pre_planes(gray: np.ndarray) -> tuple:
    """Host exact resize of a luma batch to the multi bundle's four planes
    (g32, g9x8, g8, g64) — the inputs of ops.imagehash.multihash_kernel_pre."""
    return tuple(
        resize_gray_batch(gray, h, w) for h, w in MULTI_PRE_PLANES
    )


def device_get(out):
    """Device tensors (one, or a dict of them) -> host numpy arrays."""
    if isinstance(out, dict):
        return {k: v.cpu().numpy() for k, v in out.items()}
    return out.cpu().numpy()


def _multi_outputs(rgbs: np.ndarray, device=None) -> dict:
    """Batched multi-hash over same-shape RGB uint8 [B,H,W,3]: host luma,
    and camera-size inputs pre-resized to the four planes on the host."""
    b, h, w, _ = rgbs.shape
    gray = imagehash.np_luma_u8(rgbs)
    if h * w > MULTI_PRE_THRESHOLD:
        return device_get(imagehash.multihash_kernel_pre(
            *multi_pre_planes(gray), device=device))
    return device_get(imagehash.multihash_kernel_gray(gray, h, w, device=device))


def fingerprint_multi(
    data: bytes,
    tenant_id: int,
    record_id: int,
    pre: PreprocessConfig | None = None,
    device=None,
) -> Record:
    """536-byte multi bundle (phash + dhash + ahash + hist + block)."""
    pre = pre or PreprocessConfig()
    rgb = decode_rgb(data, pre)
    out = _multi_outputs(rgb[None], device)
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.IMAGE,
        algorithm=ALGORITHM_MULTI,
        fingerprint=imagehash.serialize_multihash(out, 0),
        config_hash=pre.config_hash(),
    )


_SINGLE_ALGOS = {
    "phash": ALGORITHM_PHASH,
    "dhash": ALGORITHM_DHASH,
    "ahash": ALGORITHM_AHASH,
}


def fingerprint_single(
    data: bytes,
    algorithm: str,
    tenant_id: int,
    record_id: int,
    pre: PreprocessConfig | None = None,
    device=None,
) -> Record:
    """8-byte single hash; algorithm in {phash, dhash, ahash}."""
    if algorithm not in _SINGLE_ALGOS:
        raise ModalityError(f"unknown image algorithm: {algorithm!r}")
    pre = pre or PreprocessConfig()
    rgb = decode_rgb(data, pre)
    h, w = rgb.shape[:2]
    g = imagehash.np_luma_u8(rgb[None])
    if (h, w) != SINGLE_HASH_INPUT[algorithm]:
        # host exact resize to the hash stage's own first-stage shape
        h, w = SINGLE_HASH_INPUT[algorithm]
        g = resize_gray_batch(g, h, w)
    out = device_get(
        imagehash.single_hash_kernel_gray(g, h, w, algorithm, device=device)
    )
    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.IMAGE,
        algorithm=_SINGLE_ALGOS[algorithm],
        fingerprint=bytes(out[0]),
        config_hash=pre.config_hash(),
    )


def fingerprint_batch(
    rgbs: np.ndarray, tenant_ids: list[int], record_ids: list[int],
    pre: PreprocessConfig | None = None, device=None,
) -> list[Record]:
    """Batched multi-hash over same-shape decoded images."""
    pre = pre or PreprocessConfig()
    out = _multi_outputs(rgbs, device)
    ch = pre.config_hash()
    return [
        Record(
            tenant_id=tenant_ids[i],
            record_id=record_ids[i],
            modality=Modality.IMAGE,
            algorithm=ALGORITHM_MULTI,
            fingerprint=imagehash.serialize_multihash(out, i),
            config_hash=ch,
        )
        for i in range(rgbs.shape[0])
    ]


def semantic_features(rgb: np.ndarray) -> np.ndarray:
    """Decoded RGB -> the encoder's [3072] input (exact-int 32x32 per
    channel, scaled to [0, 1]). Split out so the ingest batcher can stack
    many requests into one encoder call."""
    chans = [
        imagehash.np_resize(rgb[..., c].astype(np.int64), 32, 32) for c in range(3)
    ]
    return (np.stack(chans, -1).astype(np.float32) / 255.0).reshape(-1)


def semantic_record(
    emb: np.ndarray, tenant_id: int, record_id: int, model_id: str | None = None
) -> Record:
    """Wrap one encoder output row into the semantic Record."""
    from ..models import IMAGE_MODEL_ID as SEMANTIC_MODEL_ID

    return Record(
        tenant_id=tenant_id,
        record_id=record_id,
        modality=Modality.IMAGE,
        algorithm=ALGORITHM_SEMANTIC,
        fingerprint=emb.astype("<f4").tobytes(),
        embedding=[float(v) for v in emb],
        model_id=model_id or SEMANTIC_MODEL_ID,
        config_hash=config_hash64(
            ALGORITHM_SEMANTIC, model_id=model_id or SEMANTIC_MODEL_ID
        ),
    )


def fingerprint_semantic(
    data: bytes,
    tenant_id: int,
    record_id: int,
    pre: PreprocessConfig | None = None,
    model_id: str | None = None,
    device=None,
) -> Record:
    """CLIP-class local embedding record (embedding slot + f32 LE bytes).

    Stands in for the reference's CLIP ONNX LocalProvider
    (image.rs:210-241); the encoder lives in models.encoders.
    """
    from ..core import UnsupportedError
    from ..device import resolve_device
    from ..models import IMAGE_MODEL_ID as SEMANTIC_MODEL_ID
    from ..models import hf_local, image_encode

    device = resolve_device(device)
    pre = pre or PreprocessConfig()
    rgb = decode_rgb(data, pre)
    if hf_local.available("image"):
        # real local weights (UCFP_MODEL_DIR/image) are THE encoder
        emb, actual = hf_local.image_embed(rgb, device=device)
    else:
        x = semantic_features(rgb)[None]
        emb = image_encode(x, device)[0]
        actual = SEMANTIC_MODEL_ID
    if model_id is not None and model_id != actual:
        # stamping a caller-supplied id onto another encoder's output
        # would forge comparability across different models — exactly
        # the cross-config comparison config_hash exists to prevent
        raise UnsupportedError(
            f"model {model_id!r} is not loaded (active encoder: {actual})"
        )
    return semantic_record(emb, tenant_id, record_id, model_id=actual)


def inspect_image(data: bytes, pre: PreprocessConfig | None = None,
                  device=None) -> dict:
    """Per-stage extractor (reference inspect_image, image.rs:291-339).

    Returns the original size, PNG-b64 thumbnails of the 32x32 and 8x8
    grayscale stages, the integer aHash mean, and the final multi bundle
    (hashed on `device`).
    """
    import base64

    from PIL import Image

    pre = pre or PreprocessConfig()
    rgb = decode_rgb(data, pre)
    h, w = rgb.shape[:2]
    gray = imagehash.np_luma(rgb)
    g32 = imagehash.np_resize(gray, 32, 32).astype(np.uint8)
    g8 = imagehash.np_resize(gray, 8, 8).astype(np.uint8)
    ahash_mean = int(g8.astype(np.uint32).sum()) // 64

    def png_b64(a: np.ndarray) -> str:
        buf = io.BytesIO()
        Image.fromarray(a, mode="L").save(buf, format="PNG")
        return base64.b64encode(buf.getvalue()).decode()

    # max-256px thumbnail of the original (visualization only: PIL's C
    # resize, not the exact-int path)
    max_edge = 256
    if max(h, w) > max_edge:
        scale = max_edge / max(h, w)
        nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
        thumb = np.asarray(
            Image.fromarray(rgb, "RGB").resize(
                (nw, nh), Image.Resampling.BILINEAR
            ),
            dtype=np.uint8,
        )
    else:
        thumb = rgb
    tbuf = io.BytesIO()
    Image.fromarray(thumb, mode="RGB").save(tbuf, format="PNG")
    # reuse the decode: fingerprint_multi would decode the input again
    out = _multi_outputs(rgb[None], device)
    fp = imagehash.serialize_multihash(out, 0)

    return {
        "algorithm": ALGORITHM_MULTI,
        "width": w,
        "height": h,
        "original_png_b64": base64.b64encode(tbuf.getvalue()).decode(),
        "gray32_png_b64": png_b64(g32),
        "gray8_png_b64": png_b64(g8),
        "ahash_mean": ahash_mean,
        "fingerprint_hex": fp.hex(),
        "fingerprint_bytes": len(fp),
        "config_hash": pre.config_hash(),
    }
