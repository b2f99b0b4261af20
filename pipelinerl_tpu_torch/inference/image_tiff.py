"""TIFF decoding on numpy and the stdlib: what ``PIL.Image.open(...)
.convert("RGB")`` gives, bit for bit, for the first image of a classic TIFF
or a little-endian BigTIFF (Pillow does not open a big-endian one).

- Layout: strips and tiles, planar configurations 1 (chunky) and 2
  (separate planes).
- Compression: none, PackBits, LZW (MSB first, early change; shared with
  GIF in ``image_lzw``), Adobe and old-style Deflate (``zlib``), and JPEG
  (7): each strip or tile is an abbreviated JPEG stream that the file's
  ``JPEGTables`` complete, decoded by the port's ``decode_jpeg`` as libtiff
  hands it to libjpeg-turbo in ``JPEGCOLORMODE_RGB``.
- The horizontal predictor (2) on 8- and 16-bit samples.
- Photometric 0 (WhiteIsZero: inverted below 16 bits, as Pillow reads it),
  1, 2, 3 (the colour map's high bytes) and 5 (CMYK, then PIL's CMYK to
  RGB), at 1, 2, 4, 8 and 16 bits (16-bit grey clipped at 255, 16-bit
  colour by its high byte), with the extra samples Pillow's ``OPEN_INFO``
  names: unassociated alpha and unspecified samples dropped, associated
  alpha (``RGBa``) divided out first as Pillow's unpacker does.
- The ``Orientation`` tag, which Pillow applies on load
  (``ImageOps.exif_transpose``).

Float, signed 16-bit and 32-bit samples, CCITT, old-style JPEG and the
other compressions, YCbCr without JPEG, and the predictor on floats raise,
naming ROADMAP Queue 1, item 16; a layout Pillow has no mode for raises as
Pillow does; a truncated or corrupt file raises saying what is wrong. No
torch: the host-only actor runs it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from . import image_pipeline
from .image_lzw import lzw_decode

# field type → (struct code, size)
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
# none, LZW, JPEG, Adobe Deflate, PackBits, old-style Deflate
_COMPRESSIONS = (1, 5, 7, 8, 32773, 32946)
_COMPRESSION_NAMES = {2: "CCITT RLE compression", 3: "CCITT Group 3 compression", 4: "CCITT Group 4 compression",
                      6: "old-style JPEG compression", 32771: "CCITT RLEW compression",
                      32809: "ThunderScan compression", 34676: "SGILog compression", 34677: "SGILog24 compression",
                      34925: "LZMA compression", 50000: "Zstandard compression", 50001: "WebP compression"}


def tiff_refusal(what: str) -> ValueError:
    return ValueError(f"a TIFF with {what}: not decoded without PIL yet; that is {image_pipeline.OTHER_FORMATS_ITEM}")


def _pil_refusal(what: str) -> ValueError:
    return ValueError(f"a TIFF with {what}, which PIL does not open either")


def _corrupt(what: str) -> ValueError:
    return ValueError(f"corrupt TIFF: {what}")


def _truncated(what: str) -> ValueError:
    return ValueError(f"truncated TIFF: {what}")


def _read_ifd(data: bytes) -> tuple[str, dict[int, tuple]]:
    """The byte order and the first IFD's tags {tag: values}."""
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("not a TIFF file: no II or MM byte order")
    (magic,) = struct.unpack(bo + "H", data[2:4])
    if magic == 42:
        big, (ifd,) = False, struct.unpack(bo + "I", data[4:8])
    elif magic == 43:
        if bo == ">":  # Pillow looks for the BigTIFF magic in the little-endian place only
            raise _pil_refusal("big-endian BigTIFF layout")
        big = True
        if len(data) < 16:
            raise _truncated("a BigTIFF header of fewer than 16 bytes")
        size, _, ifd = struct.unpack(bo + "HHQ", data[4:16])
        if size != 8:
            raise _corrupt(f"BigTIFF offsets of {size} bytes")
    else:
        raise ValueError(f"not a TIFF file: magic {magic}")
    count_fmt, entry_size, inline = ("Q", 20, 8) if big else ("H", 12, 4)
    head = struct.calcsize(count_fmt)
    if ifd + head > len(data):
        raise _truncated(f"the first IFD at byte {ifd} lies past the file's {len(data)} bytes")
    (n,) = struct.unpack(bo + count_fmt, data[ifd : ifd + head])
    if ifd + head + n * entry_size > len(data):
        raise _truncated(f"the first IFD's {n} entries run past the file's end")
    tags = {}
    for i in range(n):
        at = ifd + head + i * entry_size
        if big:
            tag, kind, count = struct.unpack(bo + "HHQ", data[at : at + 12])
            field = data[at + 12 : at + 20]
        else:
            tag, kind, count = struct.unpack(bo + "HHI", data[at : at + 8])
            field = data[at + 8 : at + 12]
        if kind not in _TYPES:
            continue
        code, size = _TYPES[kind]
        total = size * count
        if total <= inline:
            raw = field[:total]
        else:
            (off,) = struct.unpack(bo + ("Q" if big else "I"), field[: 8 if big else 4])
            if off + total > len(data):
                raise _truncated(f"tag {tag}'s {total} bytes at byte {off} run past the file's end")
            raw = data[off : off + total]
        if kind in (2, 7):
            tags[tag] = (bytes(raw),)
        else:
            tags[tag] = struct.unpack(bo + code * count, raw) if count else ()
    return bo, tags


def _packbits(raw: bytes, size: int) -> bytes:
    out = bytearray()
    pos, n = 0, len(raw)
    while len(out) < size and pos < n:
        c = raw[pos]
        pos += 1
        if c < 128:
            out += raw[pos : pos + c + 1]
            pos += c + 1
        elif c > 128:
            if pos >= n:
                break
            out += raw[pos : pos + 1] * (257 - c)
            pos += 1
    return bytes(out)


def _decompress(raw: bytes, compression: int, size: int, index: int) -> bytes:
    """One compressed strip's or tile's ``size`` bytes of samples."""
    if compression == 32773:
        out = _packbits(raw, size)
    elif compression == 5:
        if raw[:2] == b"\x00\x01" or (raw[:1] == b"\x00" and raw[1:2] and raw[1] & 1):
            raise tiff_refusal("old-style (bit-reversed) LZW compression")
        out, _ = lzw_decode(raw, 8, size, tiff=True, what="TIFF")
    else:
        inflate = zlib.decompressobj()
        try:
            out = inflate.decompress(raw, size)
        except zlib.error as e:
            raise _corrupt(f"chunk {index} does not inflate ({e})") from e
    if len(out) < size:
        raise _truncated(f"chunk {index} holds {len(out)} of its {size} bytes of samples")
    return bytes(out[:size])


def _undo_predictor(chunk: np.ndarray, spp: int) -> np.ndarray:
    """Horizontal differencing undone on rows [rows, width * spp] of
    samples: a running sum per sample across each row, wrapped."""
    rows, n = chunk.shape
    x = chunk.reshape(rows, n // spp, spp).astype(np.int64)
    wrap = 0xFFFF if chunk.dtype == np.uint16 else 0xFF
    return (np.cumsum(x, axis=1) & wrap).astype(chunk.dtype).reshape(rows, n)


# (bits per sample, extra samples) of the RGB and CMYK layouts Pillow's
# OPEN_INFO names; RGBA without ExtraSamples reads as unassociated alpha
_RGB_LAYOUTS = {((8,) * 3, ()), ((8,) * 4, ()), ((16,) * 3, ()), ((16,) * 4, ()), ((8,) * 4, (999,)),
                *(((8,) * (4 + k), (a,) + (0,) * k) for a in (0, 1, 2) for k in range(3)),
                *(((16,) * 4, (a,)) for a in (0, 1, 2))}
_CMYK_LAYOUTS = {((8,) * 4, ()), ((8,) * 5, (0,)), ((8,) * 6, (0, 0)), ((16,) * 4, ())}


def _layout(tags: dict, bo: str) -> tuple[str, tuple, tuple]:
    """Pillow's ``OPEN_INFO`` lookup, the part the port reads: → (kind,
    bits per sample, extra samples), kind one of grey, grey_inverted,
    palette, rgb, cmyk; or a refusal."""
    photo = tags.get(262, (0,))[0]
    compression = tags.get(259, (1,))[0]
    fmt = tags.get(339, (1,))
    fmt = (1,) if len(set(fmt)) == 1 and fmt[0] == 1 else fmt
    bps = tags.get(258, (1,))
    extra = tags.get(338, ())
    spp = tags.get(277, (1,))[0]
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise _pil_refusal(f"{spp} samples per pixel and bit depths {bps}")
    if 3 in fmt:
        raise tiff_refusal("float samples")
    if photo == 6 and compression != 7:
        raise tiff_refusal("YCbCr samples without JPEG compression")
    if compression == 7 and photo not in (1, 2, 6):
        raise tiff_refusal(f"JPEG compression and photometric interpretation {photo}")
    if photo not in (0, 1, 2, 3, 5, 6):
        raise tiff_refusal(f"photometric interpretation {photo}")
    unsigned = fmt == (1,)
    depth = bps[0]
    if photo in (0, 1) and spp == 1:
        if depth in (1, 2, 4, 8) and (unsigned or (photo == 1 and depth == 8)):
            return ("grey_inverted" if photo == 0 else "grey"), bps, extra
        if depth == 16 and unsigned and (photo == 1 or bo == "<"):
            return "grey", bps, extra  # WhiteIsZero at 16 bits reads as it stands
        if depth in (12, 32) or (depth == 16 and not unsigned):
            raise tiff_refusal(f"{'' if unsigned else 'signed '}{depth}-bit samples")
    elif photo == 1 and bps == (8, 8) and extra == (2,) and unsigned:
        return "grey", bps, extra
    elif photo == 3 and unsigned and (spp == 1 and depth in (1, 2, 4, 8) or bps == (8, 8) and extra in ((0,), (2,))):
        return "palette", bps, extra
    elif photo in (2, 6) and unsigned and (bps, extra) in _RGB_LAYOUTS and (photo == 2 or bps == (8,) * 3):
        return "rgb", bps, extra if extra or spp == 3 else (2,)
    elif photo == 5 and unsigned and (bps, extra) in _CMYK_LAYOUTS:
        return "cmyk", bps, extra
    raise _pil_refusal(f"photometric {photo}, bit depths {bps}, extra samples {extra}, sample format {fmt}")


def _orient(image: np.ndarray, orientation: int) -> np.ndarray:
    """``ImageOps.exif_transpose`` of an image by its ``Orientation``."""
    ops = {2: lambda a: a[:, ::-1], 3: lambda a: a[::-1, ::-1], 4: lambda a: a[::-1],
           5: lambda a: a.transpose(1, 0, 2), 6: lambda a: np.rot90(a, -1),
           7: lambda a: a.transpose(1, 0, 2)[::-1, ::-1], 8: lambda a: np.rot90(a, 1)}
    return np.ascontiguousarray(ops[orientation](image)) if orientation in ops else image


def decode_tiff(data: bytes) -> np.ndarray:
    """The RGB uint8 image [H, W, 3] of a TIFF file's first image, as PIL's
    ``Image.open(...).convert("RGB")`` gives it; a truncated or corrupt
    file raises ``ValueError`` saying what is wrong, a variant not read yet
    raises naming ROADMAP item 16."""
    data = bytes(data)
    bo, tags = _read_ifd(data)
    if 256 not in tags or 257 not in tags:
        raise _corrupt("no ImageWidth or ImageLength")
    width, height = tags[256][0], tags[257][0]
    if not width or not height:
        raise _corrupt(f"a {width}x{height} image")
    compression = tags.get(259, (1,))[0]
    if compression not in _COMPRESSIONS:
        raise tiff_refusal(_COMPRESSION_NAMES.get(compression, f"compression {compression}"))
    kind, bps, extra = _layout(tags, bo)
    spp = len(bps)
    depth = bps[0]
    planar = tags.get(284, (1,))[0]
    if planar not in (1, 2):
        raise _corrupt(f"planar configuration {planar}")
    if spp == 1:
        planar = 1
    if tags.get(266, (1,))[0] == 2 and compression != 1:
        raise tiff_refusal("fill order 2 and compression")
    predictor = tags.get(317, (1,))[0]
    if predictor not in (1, 2) or (predictor == 2 and compression in (5, 8, 32946) and depth not in (8, 16)):
        raise tiff_refusal(f"predictor {predictor} on {depth}-bit samples")
    use_predictor = predictor == 2 and compression in (5, 8, 32946)
    if 322 in tags:
        cw, ch = tags[322][0], tags.get(323, (0,))[0]
        offsets, counts = tags.get(324), tags.get(325)
    else:
        cw, ch = width, min(tags.get(278, (height,))[0], height) or height
        offsets, counts = tags.get(273), tags.get(279)
    if not offsets or not cw or not ch:
        raise _corrupt("no strip or tile offsets")
    counts = counts or tuple(len(data) - o for o in offsets)
    across, down = -(-width // cw), -(-height // ch)
    planes = spp if planar == 2 else 1
    if len(offsets) < across * down * planes or len(counts) < len(offsets):
        raise _corrupt(f"{len(offsets)} chunk offsets for {across}x{down} chunks in {planes} planes")
    per_plane = spp // planes
    row_bytes = (cw * per_plane * depth + 7) // 8
    sample_dtype = np.dtype(bo + "u2") if depth == 16 else np.dtype(np.uint8)
    if depth < 8:
        image = np.zeros((height, width), np.uint8)
    else:
        image = np.zeros((height, width, spp), np.uint16 if depth == 16 else np.uint8)
    tables = tags.get(347, (b"",))[0]
    for plane in range(planes):
        for cy in range(down):
            for cx in range(across):
                index = plane * across * down + cy * across + cx
                y0, x0 = cy * ch, cx * cw
                rows = ch if 322 in tags else min(ch, height - y0)
                off, count = offsets[index], counts[index]
                raw = data[off : off + count]
                if len(raw) < count:
                    raise _truncated(f"chunk {index} of {count} bytes at byte {off} runs past the file's end")
                h_valid, w_valid = min(rows, height - y0), min(cw, width - x0)
                if compression == 7:
                    pixels = _jpeg_chunk(tables, raw, index)
                    if pixels.shape[0] < h_valid or pixels.shape[1] < w_valid:
                        raise _corrupt(f"a {pixels.shape[1]}x{pixels.shape[0]} JPEG in chunk {index}")
                    if kind == "grey":
                        pixels = pixels[..., :1]
                    image[y0 : y0 + h_valid, x0 : x0 + w_valid] = pixels[:h_valid, :w_valid]
                    continue
                if tags.get(266, (1,))[0] == 2:
                    raw = np.unpackbits(np.frombuffer(raw, np.uint8))
                    raw = np.packbits(raw.reshape(-1, 8)[:, ::-1]).tobytes()
                if compression == 1:
                    need = (h_valid - 1) * row_bytes + (w_valid * per_plane * depth + 7) // 8
                    if len(raw) < need:
                        raise _truncated(f"chunk {index} holds {len(raw)} of its {need} bytes")
                    buf = raw[: rows * row_bytes].ljust(rows * row_bytes, b"\0")
                else:
                    buf = _decompress(raw, compression, rows * row_bytes, index)
                chunk = np.frombuffer(buf, np.uint8).reshape(rows, row_bytes)
                if depth < 8:
                    bits = np.unpackbits(chunk, axis=1)[:, : cw * depth].reshape(rows, cw, depth)
                    samples = bits.dot(1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
                    image[y0 : y0 + h_valid, x0 : x0 + w_valid] = samples[:h_valid, :w_valid]
                    continue
                samples = chunk.view(sample_dtype).reshape(rows, cw * per_plane).astype(sample_dtype.newbyteorder("="))
                if use_predictor:
                    samples = _undo_predictor(samples, per_plane)
                samples = samples.reshape(rows, cw, per_plane)[:h_valid, :w_valid]
                if planar == 2:
                    image[y0 : y0 + h_valid, x0 : x0 + w_valid, plane] = samples[..., 0]
                else:
                    image[y0 : y0 + h_valid, x0 : x0 + w_valid] = samples
    rgb = _to_rgb(image, kind, depth, extra, tags, compression == 7)
    return _orient(rgb, tags.get(274, (1,))[0])


def _jpeg_chunk(tables: bytes, raw: bytes, index: int) -> np.ndarray:
    """A JPEG strip or tile, completed by ``JPEGTables`` (its SOI and EOI
    cut), through the port's JPEG decoder."""
    if raw[:2] != b"\xff\xd8":
        raise _corrupt(f"JPEG chunk {index} does not start with SOI")
    body = raw[2:]
    if tables:
        if tables[:2] != b"\xff\xd8":
            raise _corrupt("JPEGTables does not start with SOI")
        head = tables[:-2] if tables[-2:] == b"\xff\xd9" else tables
        return image_pipeline.decode_jpeg(head + body)
    return image_pipeline.decode_jpeg(raw)


def _to_rgb(image: np.ndarray, kind: str, depth: int, extra: tuple, tags: dict, jpeg: bool) -> np.ndarray:
    """PIL's mode for the samples, then its ``convert("RGB")``."""
    if jpeg:
        return image if image.shape[-1] == 3 else np.repeat(image, 3, axis=-1)
    if kind in ("grey", "grey_inverted"):
        g = image if image.ndim == 2 else image[..., 0]
        if depth == 16:
            g = np.minimum(g, 255).astype(np.uint8)
        elif depth < 8:
            g = (g * (255 // ((1 << depth) - 1))).astype(np.uint8)
        if kind == "grey_inverted":
            g = 255 - g
        return np.repeat(g[..., None], 3, axis=2)
    if kind == "palette":
        cmap = np.asarray(tags.get(320, ()), np.int64)
        n = 1 << depth
        if cmap.size != 3 * n:
            raise _corrupt(f"a colour map of {cmap.size} entries for {depth}-bit indices")
        lut = np.zeros((256, 3), np.uint8)
        lut[:n] = (cmap.reshape(3, n).T // 256).astype(np.uint8)
        return lut[image if image.ndim == 2 else image[..., 0]]
    if depth == 16:
        image = (image >> 8).astype(np.uint8)
    if kind == "cmyk":
        return image_pipeline._cmyk_to_rgb(image[..., :4])
    rgb = image[..., :3]
    if extra[:1] == (1,):  # associated alpha: Pillow's RGBa unpacker divides it out
        a = image[..., 3:4].astype(np.int32)
        un = np.minimum(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 255)
        rgb = np.where(a == 0, 0, np.where(a == 255, rgb, un)).astype(np.uint8)
    return np.ascontiguousarray(rgb)
