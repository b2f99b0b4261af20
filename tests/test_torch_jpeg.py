"""The port's JPEG decoder (``inference/image_pipeline.decode_jpeg``)
against PIL's ``Image.open(...).convert("RGB")`` on libjpeg-turbo, bit for
bit: files PIL writes (qualities 50-100, subsampling 0-2, grey, CMYK,
progressive, optimized Huffman tables, restart markers, EXIF orientation,
sizes that are not a multiple of the MCU), and files ``encode_baseline``
below writes for what PIL's encoder does not offer (4:4:0 and other
sampling factors, separate scans, the standard tables left undefined,
SOF1, YCCK, Adobe RGB, component-id colour spaces). Truncated and corrupt
files raise saying what is wrong; arithmetic coding, 12-bit samples,
lossless JPEG and the formats not read yet raise naming ROADMAP item 16.

The committed JPEGs under ``pipelinerl_tpu_torch/fixtures/jpeg/`` (phase
26's chart images) are what ``build_fixture_jpegs`` writes, and
``digests.json`` holds the SHA-256 of PIL's RGB of each;
``python tests/test_torch_jpeg.py`` writes them again.
"""

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip

FIXTURES = Path(__file__).resolve().parents[1] / "pipelinerl_tpu_torch" / "fixtures" / "jpeg"
# phase 26's JPEG groups: (height, width) → (file, PIL save options)
FIXTURE_JPEGS = {
    (900, 900): ("chart_900x900_baseline_420.jpg", dict(quality=90, subsampling=2)),
    (780, 1000): ("chart_780x1000_progressive_444.jpg", dict(quality=90, subsampling=0, progressive=True)),
}


def noise(h, w, seed, channels=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, channels), dtype=np.uint8)


def smooth(h, w, seed):
    """Gradients with a little noise: what a photo's JPEG holds, at a
    fraction of noise's coefficients."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1), (x + y) * 127 // max(h + w - 2, 1)], -1)
    return np.clip(base + np.random.default_rng(seed).normal(0, 6, (h, w, 3)), 0, 255).astype(np.uint8)


def chart_image(h: int, w: int, seed: int) -> np.ndarray:
    """A bar chart's pixels: a light background, grid lines, an axis and
    six coloured bars, with a little noise."""
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 246.0)
    img += np.linspace(0, -18, h)[:, None, None]
    for y in range(h // 10, h, h // 8):
        img[y : y + 2, w // 12 :] = 214
    img[: h - h // 12, w // 12 : w // 12 + 3] = 40
    img[h - h // 12 : h - h // 12 + 3, w // 12 :] = 40
    colours = rng.integers(30, 220, (6, 3))
    slot = (w - w // 8) // 6
    for i, colour in enumerate(colours):
        top = int(rng.integers(h // 6, h - h // 5))
        x0 = w // 10 + i * slot
        img[top : h - h // 12, x0 : x0 + slot * 2 // 3] = colour
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def pil_jpeg(array, **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(array).save(buf, "JPEG", **kw)
    return buf.getvalue()


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes):
    got, want = ip.decode_jpeg(data), pil_rgb(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# -- a baseline encoder for what PIL's does not write --------------------------

_DCT = np.array([[(0.5 / np.sqrt(2) if u == 0 else 0.5) * np.cos((2 * x + 1) * u * np.pi / 16) for x in range(8)]
                 for u in range(8)])
QUANT = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56,
                  14, 17, 22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                  49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]) // 2 + 1


def _codes(cls: int, table: int) -> dict[int, tuple[int, int]]:
    bits, values = ip.STD_HUFFMAN[cls, table]
    codes, code, n = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[values[n]] = (code, length)
            code, n = code + 1, n + 1
        code <<= 1
    return codes


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(payload) + 2) + payload


def encode_baseline(pixels: np.ndarray, sampling, *, ids=None, app: bytes = b"", restart: int = 0, sof: int = 0xC0,
                    tables: bool = True, separate_scans: bool = False) -> bytes:
    """A Huffman-coded 8-bit JPEG of ``pixels`` [H, W, C] (the components'
    values as they are: no colour transform), component c sampled at
    ``sampling[c]`` = (h, v) by taking every (hmax / h)-th sample, the
    standard tables (written, or left for the decoder when ``tables`` is
    false), one interleaved scan or one scan per component, restart
    markers every ``restart`` MCUs."""
    h_img, w_img, nc = pixels.shape
    ids = ids or list(range(1, nc + 1))
    hmax, vmax = max(h for h, _ in sampling), max(v for _, v in sampling)
    mcux, mcuy = -(-w_img // (8 * hmax)), -(-h_img // (8 * vmax))
    coefs = []
    for c, (h, v) in enumerate(sampling):
        cw, ch = -(-w_img * h // hmax), -(-h_img * v // vmax)
        rows = np.minimum((np.arange(ch) * vmax) // v, h_img - 1)
        cols = np.minimum((np.arange(cw) * hmax) // h, w_img - 1)
        plane = pixels[rows][:, cols, c].astype(np.float64)
        plane = np.pad(plane, ((0, mcuy * v * 8 - ch), (0, mcux * h * 8 - cw)), mode="edge") - 128
        blocks = plane.reshape(mcuy * v, 8, mcux * h, 8).transpose(0, 2, 1, 3)
        coefs.append(np.rint(_DCT @ blocks @ _DCT.T / QUANT.reshape(8, 8)).astype(np.int64).reshape(
            mcuy * v, mcux * h, 64)[..., ip.NATURAL[:64]])
    dc = [_codes(0, min(c, 1)) for c in range(nc)]
    ac = [_codes(1, min(c, 1)) for c in range(nc)]

    def scan(comps: list[int]) -> bytes:
        out, acc, nbits = bytearray(), 0, 0
        preds = [0] * nc

        def put(value: int, length: int):
            nonlocal acc, nbits
            acc, nbits = (acc << length) | (value & ((1 << length) - 1)), nbits + length
            while nbits >= 8:
                byte = (acc >> (nbits - 8)) & 0xFF
                out.append(byte)
                if byte == 0xFF:
                    out.append(0)
                nbits -= 8
            acc &= (1 << nbits) - 1

        def flush():
            nonlocal acc, nbits
            if nbits:
                put((1 << (8 - nbits)) - 1, 8 - nbits)

        def block(c: int, z: np.ndarray):
            diff = int(z[0]) - preds[c]
            preds[c] = int(z[0])
            size = abs(diff).bit_length()
            put(*dc[c][size])
            put(diff if diff >= 0 else diff - 1, size)
            run = 0
            for k in range(1, 64):
                value = int(z[k])
                if not value:
                    run += 1
                    continue
                while run > 15:
                    put(*ac[c][0xF0])
                    run -= 16
                size = abs(value).bit_length()
                put(*ac[c][(run << 4) | size])
                put(value if value >= 0 else value - 1, size)
                run = 0
            if run:
                put(*ac[c][0x00])

        if len(comps) == 1:
            c = comps[0]
            h, v = sampling[c]
            cw, ch = -(-w_img * h // hmax), -(-h_img * v // vmax)
            units = [[(c, by, bx)] for by in range(-(-ch // 8)) for bx in range(-(-cw // 8))]
        else:
            units = [[(c, my * sampling[c][1] + y, mx * sampling[c][0] + x) for c in comps
                      for y in range(sampling[c][1]) for x in range(sampling[c][0])]
                     for my in range(mcuy) for mx in range(mcux)]
        for n, unit in enumerate(units):
            if restart and n and n % restart == 0:
                flush()
                out += bytes([0xFF, 0xD0 + (n // restart - 1) % 8])
                preds = [0] * nc
            for c, by, bx in unit:
                block(c, coefs[c][by, bx])
        flush()
        header = bytes([len(comps)]) + b"".join(bytes([ids[c], (min(c, 1) << 4) | min(c, 1)]) for c in comps)
        return _segment(0xDA, header + bytes([0, 63, 0])) + bytes(out)

    dqt = _segment(0xDB, b"".join(bytes([t]) + bytes(QUANT[ip.NATURAL[:64]].tolist()) for t in (0, 1)))
    frame = struct.pack(">BHHB", 8, h_img, w_img, nc) + b"".join(
        bytes([ids[c], (h << 4) | v, min(c, 1)]) for c, (h, v) in enumerate(sampling))
    dht = b""
    if tables:
        for cls, t in ((0, 0), (1, 0), (0, 1), (1, 1)):
            bits, values = ip.STD_HUFFMAN[cls, t]
            dht += _segment(0xC4, bytes([(cls << 4) | t, *bits]) + bytes(values))
    dri = _segment(0xDD, struct.pack(">H", restart)) if restart else b""
    scans = b"".join(scan([c]) for c in range(nc)) if separate_scans else scan(list(range(nc)))
    return b"\xff\xd8" + app + dqt + _segment(sof, frame) + dht + dri + scans + b"\xff\xd9"


JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    return _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, transform))


# -- files PIL writes ----------------------------------------------------------


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 90, 100])
def test_qualities_and_subsampling(quality, subsampling):
    for h, w in ((17, 9), (64, 48), (40, 56)):
        assert_decodes_as_pil(pil_jpeg(noise(h, w, h * w), quality=quality, subsampling=subsampling))
    assert_decodes_as_pil(pil_jpeg(smooth(48, 64, 1), quality=quality, subsampling=subsampling))


@pytest.mark.parametrize("size", [(1, 1), (17, 9), (9, 17), (2, 3), (3, 5), (601, 801)])
@pytest.mark.parametrize("subsampling", [0, 2])
def test_sizes(size, subsampling):
    """Sizes that are not a multiple of the MCU, down to 1x1 and the
    component widths of 1-3 samples where libjpeg-turbo's fancy
    upsampling gives way to box replication."""
    pixels = smooth(*size, 2) if size[0] > 100 else noise(*size, 3)
    assert_decodes_as_pil(pil_jpeg(pixels, quality=90, subsampling=subsampling))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("mode", ["L", "CMYK"])
def test_grey_and_cmyk(mode, progressive):
    """Grey files (one component), and CMYK as PIL writes it (an Adobe
    marker, transform 0, inverted samples: PIL reads ``CMYK;I``), then
    PIL's CMYK to RGB."""
    img = Image.fromarray(noise(23, 31, 4)).convert(mode)
    for size in ((23, 31), (8, 8)):
        buf = io.BytesIO()
        img.resize(size[::-1]).save(buf, "JPEG", quality=90, progressive=progressive)
        assert_decodes_as_pil(buf.getvalue())


@pytest.mark.parametrize("subsampling", [0, 1, 2])
def test_progressive(subsampling):
    """libjpeg's progression: DC first and refinement, AC first passes with
    EOB runs and AC refinement (spectral selection and successive
    approximation). The file decodes completely before output, so no block
    smoothing applies: the result equals PIL's whole decode."""
    for pixels in (noise(33, 41, 5), smooth(120, 97, 6)):
        data = pil_jpeg(pixels, quality=80, subsampling=subsampling, progressive=True)
        assert data[data.index(b"\xff\xc2") : data.index(b"\xff\xc2") + 2] == b"\xff\xc2"
        assert_decodes_as_pil(data)


@pytest.mark.parametrize("progressive", [False, True])
def test_optimized_tables_and_restart_markers(progressive):
    pixels = noise(45, 70, 7)
    for kw in (dict(optimize=True), dict(restart_marker_blocks=3), dict(restart_marker_rows=1),
               dict(optimize=True, restart_marker_blocks=1)):
        data = pil_jpeg(pixels, quality=85, subsampling=2, progressive=progressive, **kw)
        if "restart_marker_blocks" in kw or "restart_marker_rows" in kw:
            assert b"\xff\xdd" in data and b"\xff\xd0" in data
        assert_decodes_as_pil(data)


def test_exif_orientation_is_not_applied():
    """An EXIF-rotated file reads as stored, as PIL's ``open`` and the JAX
    path read it."""
    exif = Image.Exif()
    exif[0x0112] = 6  # rotate 90 CW to display
    data = pil_jpeg(noise(20, 30, 8), quality=90, exif=exif.tobytes())
    assert ip.decode_jpeg(data).shape == (20, 30, 3)
    assert_decodes_as_pil(data)


# -- files written here --------------------------------------------------------

SAMPLINGS = {
    "440": [(1, 2), (1, 1), (1, 1)],
    "422": [(2, 1), (1, 1), (1, 1)],
    "420": [(2, 2), (1, 1), (1, 1)],
    "chroma_2x1": [(2, 2), (2, 1), (2, 1)],
    "chroma_1x2": [(2, 2), (1, 2), (1, 2)],
    "411": [(4, 1), (1, 1), (1, 1)],
    "h3": [(3, 1), (1, 1), (1, 1)],
    "42_41": [(4, 2), (1, 1), (1, 1)],
    "luma_upsampled": [(1, 1), (2, 2), (2, 2)],
}


@pytest.mark.parametrize("name", sorted(SAMPLINGS))
def test_sampling_factors(name):
    """4:4:0 (h1v2 fancy), h2v1 and h2v2 fancy, and replication for the
    integral ratios libjpeg-turbo has no fancy path for, at sizes off the
    MCU grid and at component widths of 1-3 samples."""
    for h, w in ((37, 23), (16, 16), (5, 3), (9, 2), (1, 1), (61, 77)):
        assert_decodes_as_pil(encode_baseline(noise(h, w, h + w), SAMPLINGS[name], app=JFIF))


@pytest.mark.parametrize("variant", ["separate_scans", "default_tables", "sof1", "restart_2"])
def test_sequential_variants(variant):
    """A scan per component (non-interleaved, each over its own blocks),
    no DHT (libjpeg-turbo's standard tables), the extended-sequential
    SOF1 marker, a restart interval of two MCUs."""
    kw = {"separate_scans": dict(separate_scans=True), "default_tables": dict(tables=False),
          "sof1": dict(sof=0xC1), "restart_2": dict(restart=2)}[variant]
    for sampling in (SAMPLINGS["420"], SAMPLINGS["440"], [(1, 1)] * 3):
        assert_decodes_as_pil(encode_baseline(noise(29, 35, 9), sampling, app=JFIF, **kw))


@pytest.mark.parametrize("case", ["ycck", "cmyk_no_marker", "adobe_rgb", "rgb_ids", "ycc_ids", "adobe_ycc",
                                  "unknown_ids", "jfif_over_adobe"])
def test_colour_spaces(case):
    """libjpeg's choice of colour space (JFIF, then the Adobe transform,
    then the component ids) and PIL's inverted CMYK: YCCK (Adobe transform
    2) converts to CMYK through the YCbCr tables, then PIL's CMYK → RGB."""
    pixels = noise(19, 26, 10, channels=4 if case in ("ycck", "cmyk_no_marker") else 3)
    kw = {"ycck": dict(app=adobe(2), sampling=[(2, 2), (1, 1), (1, 1), (2, 2)]),
          "cmyk_no_marker": dict(sampling=[(1, 1)] * 4),
          "adobe_rgb": dict(app=adobe(0), ids=[82, 71, 66], sampling=[(1, 1)] * 3),
          "rgb_ids": dict(ids=[82, 71, 66], sampling=[(1, 1)] * 3),
          "ycc_ids": dict(sampling=SAMPLINGS["420"]),
          "adobe_ycc": dict(app=adobe(1), ids=[82, 71, 66], sampling=SAMPLINGS["422"]),
          "unknown_ids": dict(ids=[7, 8, 9], sampling=[(1, 1)] * 3),
          "jfif_over_adobe": dict(app=JFIF + adobe(0), sampling=[(1, 1)] * 3)}[case]
    sampling = kw.pop("sampling")
    assert_decodes_as_pil(encode_baseline(pixels, sampling, **kw))


def test_fractional_sampling_raises():
    data = encode_baseline(noise(16, 24, 11), [(3, 1), (2, 1), (2, 1)], app=JFIF)
    with pytest.raises(OSError):
        pil_rgb(data)
    with pytest.raises(ValueError, match="fractional sampling"):
        ip.decode_jpeg(data)


# -- refusals ------------------------------------------------------------------


def good_jpeg() -> bytes:
    return pil_jpeg(noise(40, 40, 12), quality=90, subsampling=2)


@pytest.mark.parametrize("cut", [0.05, 0.3, 0.6, 0.9, 0.999])
def test_truncated_files_raise(cut):
    data = good_jpeg()
    with pytest.raises(ValueError, match="truncated JPEG"):
        ip.decode_jpeg(data[: int(len(data) * cut)])


def test_corrupt_files_raise_saying_what_is_wrong():
    data = good_jpeg()
    sos = data.index(b"\xff\xda")
    start = sos + 2 + struct.unpack(">H", data[sos + 2 : sos + 4])[0]
    # all-ones bits: no code of the standard tables
    bad_codes = data[:start + 8] + b"\xff\x00" * 6 + data[start + 20 :]
    with pytest.raises(ValueError, match="Huffman code outside its table"):
        ip.decode_jpeg(bad_codes)
    dht = data.index(b"\xff\xc4")
    bad_table = bytearray(data)
    bad_table[dht + 5] = 0xFF  # a count of 255 codes of length 1
    with pytest.raises(ValueError, match="Huffman table"):
        ip.decode_jpeg(bytes(bad_table))
    dqt = data.index(b"\xff\xdb")
    no_quant = data[:dqt] + data[dqt + 2 + struct.unpack(">H", data[dqt + 2 : dqt + 4])[0] :]
    with pytest.raises(ValueError, match="quantization table"):
        ip.decode_jpeg(no_quant)
    bad_restart = encode_baseline(noise(32, 32, 13), [(1, 1)] * 3, restart=1).replace(b"\xff\xd1", b"\xff\xd3")
    with pytest.raises(ValueError, match="restart marker RST3"):
        ip.decode_jpeg(bad_restart)
    with pytest.raises(ValueError, match="not a marker"):
        ip.decode_jpeg(data[:2] + b"\x00" + data[2:])


def _patched_frame(marker: int = None, precision: int = None) -> bytes:
    data = bytearray(good_jpeg())
    sof = data.index(b"\xff\xc0")
    if marker is not None:
        data[sof + 1] = marker
    if precision is not None:
        data[sof + 4] = precision
    return bytes(data)


@pytest.mark.parametrize("case", ["arithmetic", "arithmetic_progressive", "lossless", "12_bit", "dac", "gif", "webp",
                                  "bmp", "tiff", "ico", "ppm", "tga", "tiff_float"])
def test_refused_variants_name_item_16(case):
    """Arithmetic coding, 12-bit samples and lossless JPEG, and float TIFF,
    still not read, raise naming ROADMAP item 16; GIF, WebP, BMP, TIFF, PPM
    and TGA, which item 16 held until they were ported, decode as PIL
    decodes them. PIL writes a 12x12 icon with no entry (its sizes start at
    16), which no plugin then opens: the port raises naming item 16."""
    data = {"arithmetic": lambda: _patched_frame(marker=0xC9), "arithmetic_progressive": lambda: _patched_frame(0xCA),
            "lossless": lambda: _patched_frame(marker=0xC3), "12_bit": lambda: _patched_frame(precision=12),
            "dac": lambda: good_jpeg()[:2] + _segment(0xCC, b"\x00\x10") + good_jpeg()[2:]}.get(case)
    if data is not None:
        data = data()
        match = {"arithmetic": "arithmetic coding", "arithmetic_progressive": "arithmetic coding",
                 "lossless": "lossless", "12_bit": "12-bit", "dac": "arithmetic coding"}[case]
        with pytest.raises(ValueError, match=f"{match}.*item 16"):
            ip.decode_jpeg(data)
        return
    buf = io.BytesIO()
    if case == "tiff_float":
        Image.fromarray(noise(12, 12, 14)[..., 0].astype(np.float32)).save(buf, "TIFF")
    else:
        Image.fromarray(noise(12, 12, 14)).save(buf, case.upper())
    if case in ("gif", "webp", "bmp", "tiff", "ppm", "tga"):
        assert ip.image_kind(buf.getvalue()) == {"gif": "GIF", "webp": "WebP", "bmp": "BMP", "tiff": "TIFF",
                                                 "ppm": "PPM", "tga": "TGA"}[case]
        np.testing.assert_array_equal(ip.decode_image(buf.getvalue()), pil_rgb(buf.getvalue()))
        return
    with pytest.raises(ValueError, match="float samples.*item 16" if case == "tiff_float" else "item 16"):
        ip.decode_image(buf.getvalue())


def test_decode_image_routes_by_magic():
    pixels = noise(10, 14, 15)
    np.testing.assert_array_equal(ip.decode_image(pil_jpeg(pixels, quality=95)), pil_rgb(pil_jpeg(pixels, quality=95)))
    buf = io.BytesIO()
    Image.fromarray(pixels).save(buf, "PNG")
    np.testing.assert_array_equal(ip.decode_image(buf.getvalue()), pixels)
    with pytest.raises(ValueError, match="not a JPEG but a PNG"):
        ip.decode_jpeg(buf.getvalue())


# -- the committed fixtures ----------------------------------------------------


def build_fixture_jpegs() -> dict[str, bytes]:
    """Phase 26's JPEGs: chart images, a baseline 4:2:0 one at 900x900 and
    a progressive 4:4:4 one at 780x1,000."""
    return {name: pil_jpeg(chart_image(h, w, seed=h), **kw) for (h, w), (name, kw) in FIXTURE_JPEGS.items()}


def digests(files: dict[str, bytes]) -> dict[str, str]:
    return {name: hashlib.sha256(pil_rgb(data).tobytes()).hexdigest() for name, data in files.items()}


def test_fixture_jpegs_are_what_the_builder_writes():
    built = build_fixture_jpegs()
    for name, data in built.items():
        assert (FIXTURES / name).read_bytes() == data, name
        assert_decodes_as_pil(data)
        got = ip.decode_jpeg(data)
        assert hashlib.sha256(got.tobytes()).hexdigest() == json.loads((FIXTURES / "digests.json").read_text())[name]
    assert json.loads((FIXTURES / "digests.json").read_text()) == digests(built)


if __name__ == "__main__":
    FIXTURES.mkdir(parents=True, exist_ok=True)
    files = build_fixture_jpegs()
    for name, data in files.items():
        (FIXTURES / name).write_bytes(data)
    (FIXTURES / "digests.json").write_text(json.dumps(digests(files), indent=1) + "\n")
