"""The port's XBM and XPM decoders (``inference/image_xbm``) against PIL's
``Image.open(...).convert("RGB")``, bit for bit: XBM files PIL writes (with
and without a hot spot) and hand-written ones (upper-case hex, widths that
are not a multiple of 8, ``_bits[]`` declarations of other types), and
XPM files ``encode_xpm`` below writes (1 and 2 characters a pixel, up to
256 colours through a palette and more looked up directly, a ``/*
pixels */`` line, ``#RGB`` and ``#RRGGBB`` colours). A named colour, a
pixel of a transparent key and truncated files fail in both packages.
"""

import io

import numpy as np
import pytest
from PIL import Image

from pipelinerl_tpu_torch.inference import image_pipeline as ip
from pipelinerl_tpu_torch.inference.image_xbm import decode_xbm, decode_xpm

KEYS = "".join(chr(c) for c in range(35, 127) if chr(c) not in '"\\')


def pil_rgb(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_decodes_as_pil(data: bytes, kind: str) -> None:
    want = pil_rgb(data)
    assert Image.open(io.BytesIO(data)).format == kind
    np.testing.assert_array_equal((decode_xbm if kind == "XBM" else decode_xpm)(data), want)
    np.testing.assert_array_equal(ip.decode_image(data), want)


def both_fail(data: bytes) -> None:
    with pytest.raises(Exception):
        pil_rgb(data)
    with pytest.raises(ValueError):
        ip.decode_image(data)


def encode_xbm(bits: np.ndarray, upper: bool = False, kind: str = "static char") -> bytes:
    """An XBM of ``bits`` [h, w] (1 white), least significant bit first."""
    h, w = bits.shape
    packed = np.packbits(bits.astype(bool), axis=1, bitorder="little").reshape(-1)
    values = ", ".join(("0x%02X" if upper else "0x%02x") % v for v in packed)
    return (f"#define chart_width {w}\n#define chart_height {h}\n{kind} chart_bits[] = {{\n{values} }};\n").encode()


def encode_xpm(indices: np.ndarray, colours: list[str], cpp: int, pixels_comment: bool = True) -> bytes:
    """An XPM of ``indices`` [h, w] into ``colours`` (``c`` values), each
    key ``cpp`` characters."""
    h, w = indices.shape
    keys = ["".join(KEYS[(i // len(KEYS) ** j) % len(KEYS)] for j in range(cpp)) for i in range(len(colours))]
    lines = ["/* XPM */", "static char *chart[] = {", "/* columns rows colors chars-per-pixel */",
             f'"{w} {h} {len(colours)} {cpp}",']
    lines += [f'"{k} c {c}",' for k, c in zip(keys, colours)]
    if pixels_comment:
        lines.append("/* pixels */")
    lines += ['"' + "".join(keys[i] for i in row) + '",' for row in indices.tolist()]
    lines.append("};")
    return "\n".join(lines).encode() + b"\n"


def noise(shape, seed, high=256):
    return np.random.default_rng(seed).integers(0, high, shape)


@pytest.mark.parametrize("hotspot", [None, (3, 5)])
@pytest.mark.parametrize("width", [16, 21])
def test_xbm_files_pil_writes(hotspot, width):
    image = Image.fromarray(noise((11, width), 1) > 127)
    buf = io.BytesIO()
    image.save(buf, "XBM", **({"hotspot": hotspot} if hotspot else {}))
    assert_decodes_as_pil(buf.getvalue(), "XBM")


@pytest.mark.parametrize("upper", [False, True])
@pytest.mark.parametrize("width", [1, 7, 9, 30])
@pytest.mark.parametrize("kind", ["static char", "static unsigned char"])
def test_xbm_hand_written(upper, width, kind):
    assert_decodes_as_pil(encode_xbm(noise((6, width), width, 2), upper, kind), "XBM")


@pytest.mark.parametrize("n_colours, cpp", [(2, 1), (60, 1), (256, 2), (300, 2)])
@pytest.mark.parametrize("short_hex", [False, True])
def test_xpm_palettes(n_colours, cpp, short_hex):
    rng = np.random.default_rng(n_colours)
    colours = [("#%03x" if short_hex and i % 3 == 0 else "#%06x") % int(rng.integers(0, 2**24 if i % 3 else 2**12))
               for i in range(n_colours)]
    indices = noise((9, 17), n_colours, n_colours)
    assert_decodes_as_pil(encode_xpm(indices, colours, cpp, pixels_comment=bool(n_colours % 2)), "XPM")


@pytest.mark.parametrize("case", ["named_colour", "transparent_pixel", "truncated_xpm", "truncated_xbm", "no_values"])
def test_faults_fail_in_both(case):
    indices = noise((4, 5), 2, 2)
    if case == "named_colour":
        data = encode_xpm(indices, ["#ffffff", "red"], 1)
    elif case == "transparent_pixel":  # Pillow keeps None as transparency only: no palette entry for the pixel
        data = encode_xpm(indices, ["#ffffff", "None"], 1)
    elif case == "truncated_xpm":
        data = encode_xpm(indices, ["#ffffff", "#000000"], 1)[:-20]
    elif case == "truncated_xbm":
        data = encode_xbm(noise((6, 16), 1, 2))[:-25]
    else:
        data = b"/* XPM */\nstatic char *x[] = {\n};\n"
    both_fail(data)
