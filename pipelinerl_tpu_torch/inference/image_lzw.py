"""LZW decoding for GIF and TIFF, on the stdlib.

The two variants differ in three ways: GIF reads codes LSB first from a
minimum code size the file names (clear code ``1 << size``), and widens
the codes when the table's next entry reaches ``1 << width``; TIFF reads
them MSB first from 9 bits (clear 256, end 257) and widens one entry
earlier (libtiff's early change). Both stop growing the table at 4,096
entries. No torch: the host-only actor runs it.
"""

from __future__ import annotations


def lzw_decode(data: bytes, min_bits: int, limit: int, tiff: bool, what: str) -> tuple[bytearray, bool]:
    """Up to ``limit`` decoded bytes of an LZW stream → (the bytes, whether
    the stream ended by its end code or by reaching ``limit`` rather than by
    running out of data). A code that names no entry yet raises
    ``ValueError`` naming ``what``."""
    clear = 1 << min_bits
    end = clear + 1
    early = 1 if tiff else 0
    out = bytearray()
    roots = [bytes([i]) for i in range(clear)] + [b"", b""]
    table = list(roots)
    width = min_bits + 1
    prev = None
    acc = nbits = pos = 0
    n = len(data)
    while len(out) < limit:
        while nbits < width:
            if pos >= n:
                return out, False
            if tiff:
                acc = (acc << 8) | data[pos]
            else:
                acc |= data[pos] << nbits
            pos += 1
            nbits += 8
        if tiff:
            nbits -= width
            code = (acc >> nbits) & ((1 << width) - 1)
            acc &= (1 << nbits) - 1
        else:
            code = acc & ((1 << width) - 1)
            acc >>= width
            nbits -= width
        if code == clear:
            table = list(roots)
            width = min_bits + 1
            prev = None
            continue
        if code == end:
            return out, True
        if prev is None:
            if code > clear:
                raise ValueError(f"corrupt {what}: LZW code {code} right after a clear code")
            entry = table[code]
        else:
            nxt = len(table)
            if code < nxt:
                entry = table[code]
            elif code == nxt:
                entry = prev + prev[:1]
            else:
                raise ValueError(f"corrupt {what}: LZW code {code} past the table's {nxt} entries")
            if nxt < 4096:
                table.append(prev + entry[:1])
                if nxt + 1 + early == 1 << width and width < 12:
                    width += 1
        out += entry
        prev = entry
    return out, True
