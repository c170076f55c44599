"""Ogg pages and packets (RFC 3533), for the Vorbis decoder.

``read_packets(data) -> (packets, serial)``: the packets of the file's
first logical stream in order, each with the granule position of the page
it completes on (-1 for the others on that page) and the end-of-stream
flag of the last one. Pages carry a CRC-32 (polynomial 0x04C11DB7, no
reflection, the CRC field zeroed while summing); a page whose CRC does not
match is corrupt and raises ``AudioDecodeError``. A page cut short by the
end of the file ends the stream there, as libvorbisfile's reader does.
Pages of other serials interleaved with the first stream (a grouped file)
are skipped; a second stream that begins after the first one ended (a
chained file) is refused with ``UnsupportedFormatError``.
"""
from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import List, Tuple

from .codec import AudioDecodeError, UnsupportedFormatError

MAX_PACKET = 1 << 24  # no Vorbis header or audio packet comes near 16 MiB


def crc32(data: bytes) -> int:
    """Ogg's CRC-32: polynomial 0x04C11DB7, no reflection, initial 0, no
    final xor. The plain loop; ``page_crc`` computes the same through
    zlib's reflected CRC on bit-reversed bytes."""
    crc = 0
    for b in data:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) & 0xFFFFFFFF \
                if crc & 0x80000000 else (crc << 1) & 0xFFFFFFFF
    return crc


_REVERSE = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def page_crc(data: bytes, start: int, end: int) -> int:
    """Ogg's CRC of the page ``data[start:end]``, its CRC field as zeros."""
    page = bytearray(data[start:end])
    page[22:26] = b"\x00\x00\x00\x00"
    r = zlib.crc32(bytes(page).translate(_REVERSE), 0xFFFFFFFF) ^ 0xFFFFFFFF
    return int(f"{r:032b}"[::-1], 2)


@dataclass
class Packet:
    data: bytes
    granule: int   # -1 unless the packet is the last completed on its page
    eos: bool      # the last packet of the stream's last page


def read_packets(data: bytes) -> Tuple[List[Packet], int]:
    """The first logical stream's packets, and its serial number."""
    pos = 0
    n = len(data)
    serial = None
    ended = False
    packets: List[Packet] = []
    partial = bytearray()
    while pos + 27 <= n:
        if data[pos:pos + 4] != b"OggS":
            raise AudioDecodeError(f"lost Ogg page sync at byte {pos}")
        version, flags = data[pos + 4], data[pos + 5]
        granule, page_serial, _seq, stored = struct.unpack_from(
            "<qIII", data, pos + 6)
        n_seg = data[pos + 26]
        if version != 0:
            raise AudioDecodeError(f"Ogg page version {version}")
        if pos + 27 + n_seg > n:
            break
        lacing = data[pos + 27:pos + 27 + n_seg]
        body = pos + 27 + n_seg
        end = body + sum(lacing)
        if end > n:
            break  # a page cut short by the end of the file
        if page_crc(data, pos, end) != stored:
            raise AudioDecodeError(f"Ogg page CRC mismatch at byte {pos}")
        if serial is None:
            if not flags & 2:
                raise AudioDecodeError("Ogg stream does not begin with a "
                                       "beginning-of-stream page")
            serial = page_serial
        elif page_serial != serial:
            if ended and flags & 2:
                raise UnsupportedFormatError(
                    "chained Ogg streams (a second logical stream after "
                    "the first ends) are not supported")
            pos = end
            continue
        elif ended:
            raise AudioDecodeError("Ogg page after the end of its stream")
        if not flags & 1:
            partial.clear()  # a fresh page: a dangling packet is dropped
        at = body
        last_done = -1
        for lace in lacing:
            partial += data[at:at + lace]
            at += lace
            if len(partial) > MAX_PACKET:
                raise AudioDecodeError("Ogg packet too large")
            if lace < 255:
                packets.append(Packet(bytes(partial), -1, False))
                partial.clear()
                last_done = len(packets) - 1
        if last_done >= 0:
            packets[last_done].granule = granule
        if flags & 4:
            ended = True
            if packets:
                packets[-1].eos = True
        pos = end
    if serial is None:
        raise AudioDecodeError("no complete Ogg page")
    return packets, serial

