"""Dependency-free FLAC codec (decoder and a minimal encoder), in numpy.

The PyTorch port's own copy of ``glow_tts_tpu/data/flac.py`` (the port
imports nothing of the JAX package); a CPU test holds the two equal.

* **decoder**: STREAMINFO, frame headers (every block-size, sample-rate
  and sample-size code), subframe types CONSTANT / VERBATIM / FIXED(0-4) /
  LPC(1-32), wasted bits, Rice/Rice2 residuals with escape partitions,
  stereo decorrelation (left-side / right-side / mid-side), CRC-8/CRC-16
  checks, an optional MD5 check of the decoded stream;
* **encoder**: enough of the format to write test streams that take every
  decoder path (verbatim, constant, fixed + Rice, LPC + Rice, wasted bits,
  mid-side stereo, escape partitions) and to round-trip any PCM losslessly.

Pure Python bit IO is slow (~20× real time for 24 kHz mono speech): the
ETL's decode chain (:mod:`glow_tts_tpu_torch.data.audio_io`) prefers
soundfile where it is installed and falls back here, so flac corpora
always decode.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}
_SAMPLE_RATES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
                 6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
                 11: 96000}
_SAMPLE_SIZES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1],
                 4: [4, -6, 4, -1]}


def _crc_table(poly: int, width: int) -> np.ndarray:
    table = np.zeros(256, np.uint32)
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for i in range(256):
        crc = i << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        table[i] = crc & mask
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]) ^ ((crc << 8)
                                                            & 0xFFFF)
    return crc


class BitReader:
    """MSB-first bit reader over a byte buffer.

    Bits are expanded once into a 0/1 array; unary runs (the hot path of
    Rice decoding) resolve via a sorted index of set bits + searchsorted
    instead of a scan.
    """

    def __init__(self, data: bytes):
        self.data = data
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.ones = np.flatnonzero(self.bits)
        self.pos = 0
        self._pow = (1 << np.arange(63, -1, -1, dtype=np.uint64))

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        chunk = self.bits[self.pos:self.pos + n]
        if chunk.shape[0] != n:
            raise ValueError('flac: truncated stream')
        self.pos += n
        return int(chunk.astype(np.uint64) @ self._pow[-n:])

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def unary(self) -> int:
        i = np.searchsorted(self.ones, self.pos)
        if i >= self.ones.shape[0]:
            raise ValueError('flac: truncated unary code')
        stop = int(self.ones[i])
        count = stop - self.pos
        self.pos = stop + 1
        return count

    def align(self) -> None:
        self.pos = (self.pos + 7) // 8 * 8

    def byte_pos(self) -> int:
        return self.pos // 8


class BitWriter:
    def __init__(self):
        self.chunks: List[np.ndarray] = []
        self.nbits = 0

    def write(self, value: int, n: int) -> None:
        if n == 0:
            return
        value &= (1 << n) - 1
        out = np.empty(n, np.uint8)
        for i in range(n):
            out[i] = (value >> (n - 1 - i)) & 1
        self.chunks.append(out)
        self.nbits += n

    def write_signed(self, value: int, n: int) -> None:
        self.write(value & ((1 << n) - 1), n)

    def write_unary(self, q: int) -> None:
        out = np.zeros(q + 1, np.uint8)
        out[-1] = 1
        self.chunks.append(out)
        self.nbits += q + 1

    def align(self) -> None:
        pad = (-self.nbits) % 8
        if pad:
            self.write(0, pad)

    def getvalue(self) -> bytes:
        self.align()
        return np.packbits(np.concatenate(self.chunks)
                           if self.chunks else np.zeros(0, np.uint8)
                           ).tobytes()


def _utf8_decode(reader: BitReader) -> int:
    first = reader.read(8)
    if first < 0x80:
        return first
    n = 0
    probe = first
    while probe & 0x80:
        n += 1
        probe = (probe << 1) & 0xFF
    if n < 2 or n > 7:
        raise ValueError('flac: bad UTF-8 coded number')
    value = first & (0x7F >> n)
    for _ in range(n - 1):
        cont = reader.read(8)
        if cont & 0xC0 != 0x80:
            raise ValueError('flac: bad UTF-8 continuation byte')
        value = (value << 6) | (cont & 0x3F)
    return value


def _utf8_encode(value: int) -> bytes:
    if value < 0x80:
        return bytes([value])
    for n, limit in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31), (7, 36)):
        if value < (1 << limit):
            lead = (0xFF << (8 - n)) & 0xFF
            out = [lead | (value >> (6 * (n - 1)))]
            for i in range(n - 2, -1, -1):
                out.append(0x80 | ((value >> (6 * i)) & 0x3F))
            return bytes(out)
    raise ValueError('flac: frame number out of range')


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _read_residual(reader: BitReader, block_size: int, order: int
                   ) -> np.ndarray:
    method = reader.read(2)
    if method > 1:
        raise ValueError('flac: reserved residual coding method')
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    partition_order = reader.read(4)
    partitions = 1 << partition_order
    if block_size % partitions:
        raise ValueError('flac: block size not divisible by partitions')
    samples_per = block_size >> partition_order
    residual = np.empty(block_size - order, np.int64)
    out = 0
    for p in range(partitions):
        count = samples_per - (order if p == 0 else 0)
        param = reader.read(param_bits)
        if param == escape:
            raw_bits = reader.read(5)
            for i in range(count):
                residual[out + i] = (reader.read_signed(raw_bits)
                                     if raw_bits else 0)
        else:
            for i in range(count):
                q = reader.unary()
                v = (q << param) | reader.read(param)
                residual[out + i] = (v >> 1) ^ -(v & 1)
        out += count
    return residual


def _predict(warmup: np.ndarray, residual: np.ndarray,
             coeffs: List[int], shift: int) -> np.ndarray:
    order = len(coeffs)
    n = warmup.shape[0] + residual.shape[0]
    x = np.empty(n, np.int64)
    x[:order] = warmup
    c = np.array(coeffs, np.int64)
    for i in range(order, n):
        # history is x[i-1], x[i-2], ... matching coeffs[0], coeffs[1], ...
        acc = int(c @ x[i - order:i][::-1]) if order else 0
        x[i] = (acc >> shift) + residual[i - order]
    return x


def _read_subframe(reader: BitReader, block_size: int, bps: int
                   ) -> np.ndarray:
    if reader.read(1):
        raise ValueError('flac: subframe padding bit set')
    sf_type = reader.read(6)
    wasted = 0
    if reader.read(1):
        wasted = reader.unary() + 1
    bps -= wasted
    if sf_type == 0:                                    # CONSTANT
        value = reader.read_signed(bps)
        x = np.full(block_size, value, np.int64)
    elif sf_type == 1:                                  # VERBATIM
        x = np.array([reader.read_signed(bps) for _ in range(block_size)],
                     np.int64)
    elif 8 <= sf_type <= 12:                            # FIXED order 0-4
        order = sf_type - 8
        warmup = np.array([reader.read_signed(bps) for _ in range(order)],
                          np.int64)
        residual = _read_residual(reader, block_size, order)
        x = _predict(warmup, residual, _FIXED_COEFFS[order], 0)
    elif sf_type >= 32:                                 # LPC
        order = (sf_type & 31) + 1
        warmup = np.array([reader.read_signed(bps) for _ in range(order)],
                          np.int64)
        precision = reader.read(4) + 1
        if precision == 16:
            raise ValueError('flac: invalid LPC precision code')
        shift = reader.read_signed(5)
        if shift < 0:
            raise ValueError('flac: negative LPC shift')
        coeffs = [reader.read_signed(precision) for _ in range(order)]
        residual = _read_residual(reader, block_size, order)
        x = _predict(warmup, residual, coeffs, shift)
    else:
        raise ValueError(f'flac: reserved subframe type {sf_type}')
    return x << wasted


class StreamInfo:
    def __init__(self, raw: bytes):
        (self.min_block, self.max_block) = struct.unpack('>HH', raw[:4])
        self.min_frame = int.from_bytes(raw[4:7], 'big')
        self.max_frame = int.from_bytes(raw[7:10], 'big')
        packed = int.from_bytes(raw[10:18], 'big')
        self.sample_rate = packed >> 44
        self.channels = ((packed >> 41) & 0x7) + 1
        self.bits_per_sample = ((packed >> 36) & 0x1F) + 1
        self.total_samples = packed & ((1 << 36) - 1)
        self.md5 = raw[18:34]


def decode(data: bytes, verify_md5: bool = True
           ) -> Tuple[np.ndarray, int, int]:
    """FLAC bytes → (samples [T, C] int32, sample_rate, bits_per_sample)."""
    if data[:4] != b'fLaC':
        raise ValueError('flac: missing fLaC marker')
    offset = 4
    info: Optional[StreamInfo] = None
    while True:
        header = data[offset]
        length = int.from_bytes(data[offset + 1:offset + 4], 'big')
        block_type = header & 0x7F
        body = data[offset + 4:offset + 4 + length]
        if block_type == 0:
            info = StreamInfo(body)
        offset += 4 + length
        if header & 0x80:
            break
    if info is None:
        raise ValueError('flac: no STREAMINFO block')

    reader = BitReader(data[offset:])
    total_bits = reader.bits.shape[0]
    channels_out: List[np.ndarray] = []
    while total_bits - reader.pos >= 16:
        frame_start = reader.byte_pos()
        sync = reader.read(14)
        if sync != 0x3FFE:
            raise ValueError('flac: lost frame sync')
        reader.read(1)                       # reserved
        reader.read(1)                       # blocking strategy
        bs_code = reader.read(4)
        sr_code = reader.read(4)
        ch_code = reader.read(4)
        ss_code = reader.read(3)
        reader.read(1)                       # reserved
        _utf8_decode(reader)                 # frame / sample number
        if bs_code == 6:
            block_size = reader.read(8) + 1
        elif bs_code == 7:
            block_size = reader.read(16) + 1
        elif bs_code in _BLOCK_SIZES:
            block_size = _BLOCK_SIZES[bs_code]
        else:
            raise ValueError('flac: reserved block size code')
        if sr_code == 0:
            pass
        elif sr_code == 12:
            reader.read(8)
        elif sr_code in (13, 14):
            reader.read(16)
        elif sr_code not in _SAMPLE_RATES:
            raise ValueError('flac: bad sample rate code')
        bps = (info.bits_per_sample if ss_code == 0
               else _SAMPLE_SIZES[ss_code])
        header_bytes = data[offset + frame_start:
                            offset + reader.byte_pos()]
        if crc8(header_bytes) != reader.read(8):
            raise ValueError('flac: frame header CRC-8 mismatch')

        if ch_code < 8:
            n_channels = ch_code + 1
            subframes = [_read_subframe(reader, block_size, bps)
                         for _ in range(n_channels)]
        elif ch_code in (8, 9, 10):
            n_channels = 2
            left_bps = bps + (1 if ch_code == 9 else 0)
            side_bps = bps + (1 if ch_code in (8, 10) else 0)
            a = _read_subframe(reader, block_size, left_bps)
            b = _read_subframe(reader, block_size, side_bps)
            if ch_code == 8:                 # left / side
                subframes = [a, a - b]
            elif ch_code == 9:               # side / right
                subframes = [a + b, b]
            else:                            # mid / side
                mid = (a << 1) | (b & 1)
                subframes = [(mid + b) >> 1, (mid - b) >> 1]
        else:
            raise ValueError('flac: reserved channel assignment')

        reader.align()
        frame_bytes = data[offset + frame_start:offset + reader.byte_pos()]
        if crc16(frame_bytes) != reader.read(16):
            raise ValueError('flac: frame CRC-16 mismatch')
        channels_out.append(np.stack(subframes, axis=-1))
        if info.total_samples and \
                sum(c.shape[0] for c in channels_out) >= info.total_samples:
            break

    samples = np.concatenate(channels_out, axis=0)
    if info.total_samples:
        samples = samples[:info.total_samples]
    if verify_md5 and info.md5 != b'\x00' * 16:
        width = (info.bits_per_sample + 7) // 8
        digest = hashlib.md5(_interleave_bytes(samples, width)).digest()
        if digest != info.md5:
            raise ValueError('flac: decoded stream fails the MD5 check')
    return samples.astype(np.int32), info.sample_rate, info.bits_per_sample


def read(path: str) -> Tuple[np.ndarray, int]:
    """Decode a flac file → (float32 audio in [-1, 1], sample_rate).

    Mono files come back [T]; multi-channel [T, C] (matching
    ``soundfile.read``'s layout so callers can downmix identically).
    """
    with open(path, 'rb') as handle:
        samples, sample_rate, bps = decode(handle.read())
    audio = samples.astype(np.float32) / float(1 << (bps - 1))
    if audio.shape[1] == 1:
        audio = audio[:, 0]
    return audio, sample_rate


def _interleave_bytes(samples: np.ndarray, width: int) -> bytes:
    flat = samples.reshape(-1).astype(np.int64)
    out = np.empty((flat.shape[0], width), np.uint8)
    for i in range(width):                   # little-endian per sample
        out[:, i] = (flat >> (8 * i)) & 0xFF
    return out.tobytes()


# ---------------------------------------------------------------------------
# encoder (fixture generation + lossless round-trip)
# ---------------------------------------------------------------------------

def _rice_param(residual: np.ndarray, param_bits: int) -> int:
    mean = float(np.mean(np.abs(residual))) if residual.size else 0.0
    k = 0
    while (1 << k) < mean + 1 and k < (1 << param_bits) - 2:
        k += 1
    return k


def _write_residual(writer: BitWriter, residual: np.ndarray,
                    block_size: int, order: int,
                    force_escape: bool = False) -> None:
    writer.write(0, 2)                       # 4-bit Rice parameters
    writer.write(0, 4)                       # partition order 0
    if force_escape:
        writer.write(15, 4)                  # escape code
        raw_bits = max(int(np.abs(residual).max()).bit_length() + 1, 2) \
            if residual.size else 2
        writer.write(raw_bits, 5)
        for v in residual:
            writer.write_signed(int(v), raw_bits)
        return
    param = _rice_param(residual, 4)
    writer.write(param, 4)
    for v in residual:
        v = int(v)
        u = (abs(v) << 1) - (1 if v < 0 else 0)   # zigzag
        writer.write_unary(u >> param)
        writer.write(u & ((1 << param) - 1), param)


def _encode_subframe(writer: BitWriter, x: np.ndarray, bps: int,
                     strategy: str, force_escape: bool) -> None:
    writer.write(0, 1)                       # padding
    wasted = 0
    if strategy == 'wasted' and x.size and np.any(x):
        nonzero = x[x != 0]
        wasted = min(int(np.min([(int(v) & -int(v)).bit_length() - 1
                                 for v in nonzero])), 7)
        strategy = 'verbatim'
    if np.all(x == x[0]) and strategy not in ('verbatim',):
        writer.write(0, 6)
        writer.write(0, 1)
        writer.write_signed(int(x[0]), bps)
        return
    if wasted:
        x = x >> wasted
        bps -= wasted
    if strategy == 'verbatim':
        writer.write(1, 6)
        if wasted:
            writer.write(1, 1)
            writer.write_unary(wasted - 1)
        else:
            writer.write(0, 1)
        for v in x:
            writer.write_signed(int(v), bps)
    elif strategy == 'fixed':
        order = min(2, x.shape[0] - 1)
        coeffs = np.array(_FIXED_COEFFS[order], np.int64)
        writer.write(8 | order, 6)
        writer.write(0, 1)
        for v in x[:order]:
            writer.write_signed(int(v), bps)
        residual = np.array(
            [int(x[i]) - (int(coeffs @ x[i - order:i][::-1])
                          if order else 0)
             for i in range(order, x.shape[0])], np.int64)
        _write_residual(writer, residual, x.shape[0], order, force_escape)
    elif strategy == 'lpc':
        order = min(2, x.shape[0] - 1)
        coeffs = [2, -1][:order]             # fixed-2 poly via the LPC path
        shift = 0
        writer.write(32 | (order - 1), 6)
        writer.write(0, 1)
        for v in x[:order]:
            writer.write_signed(int(v), bps)
        precision = 5
        writer.write(precision - 1, 4)
        writer.write_signed(shift, 5)
        for c in coeffs:
            writer.write_signed(c, precision)
        carr = np.array(coeffs, np.int64)
        residual = np.array(
            [int(x[i]) - (int(carr @ x[i - order:i][::-1]) >> shift)
             for i in range(order, x.shape[0])], np.int64)
        _write_residual(writer, residual, x.shape[0], order, force_escape)
    else:
        raise ValueError(f'unknown subframe strategy {strategy!r}')


def encode(samples: np.ndarray, sample_rate: int,
           bits_per_sample: int = 16, block_size: int = 1024,
           strategy: str = 'fixed', mid_side: bool = False,
           force_escape: bool = False) -> bytes:
    """PCM int samples [T] or [T, C] → FLAC bytes (lossless)."""
    if samples.ndim == 1:
        samples = samples[:, None]
    samples = samples.astype(np.int64)
    total, n_channels = samples.shape
    if mid_side and n_channels != 2:
        raise ValueError('mid_side needs exactly 2 channels')

    out = bytearray(b'fLaC')
    packed = (sample_rate << 44) | ((n_channels - 1) << 41) \
        | ((bits_per_sample - 1) << 36) | total
    info = struct.pack('>HH', min(block_size, total or block_size),
                       block_size) \
        + b'\x00\x00\x00' + b'\x00\x00\x00' \
        + packed.to_bytes(8, 'big') \
        + hashlib.md5(_interleave_bytes(
            samples, (bits_per_sample + 7) // 8)).digest()
    out += bytes([0x80]) + len(info).to_bytes(3, 'big') + info

    for frame_idx, start in enumerate(range(0, total, block_size)):
        block = samples[start:start + block_size]
        writer = BitWriter()
        writer.write(0x3FFE, 14)
        writer.write(0, 1)                   # reserved
        writer.write(0, 1)                   # fixed block size strategy
        writer.write(7, 4)                   # 16-bit explicit block size
        writer.write(13, 4)                  # 16-bit explicit sample rate
        ch_code = 10 if mid_side else n_channels - 1
        writer.write(ch_code, 4)
        ss_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bits_per_sample]
        writer.write(ss_code, 3)
        writer.write(0, 1)                   # reserved
        for b in _utf8_encode(frame_idx):
            writer.write(b, 8)
        writer.write(block.shape[0] - 1, 16)
        writer.write(sample_rate, 16)
        header = writer.getvalue()
        writer.chunks = [np.unpackbits(np.frombuffer(header, np.uint8))]
        writer.nbits = len(header) * 8
        writer.write(crc8(header), 8)

        if mid_side:
            left, right = block[:, 0], block[:, 1]
            mid, side = (left + right) >> 1, left - right
            _encode_subframe(writer, mid, bits_per_sample, strategy,
                             force_escape)
            _encode_subframe(writer, side, bits_per_sample + 1, strategy,
                             force_escape)
        else:
            for c in range(n_channels):
                _encode_subframe(writer, block[:, c], bits_per_sample,
                                 strategy, force_escape)
        writer.align()
        body = writer.getvalue()
        out += body + struct.pack('>H', crc16(body))
    return bytes(out)


def write(path: str, audio: np.ndarray, sample_rate: int, **kwargs) -> None:
    """float32 [-1, 1] (or int16) audio → flac file."""
    if audio.dtype.kind == 'f':
        audio = np.clip(np.round(audio * 32767.0), -32768, 32767
                        ).astype(np.int64)
    with open(path, 'wb') as handle:
        handle.write(encode(audio, sample_rate, **kwargs))
