"""Pure-python Keccak-256 (the pre-NIST padding variant used by Ethereum).

Needed for the RollingKeccakTranscript (SURVEY D1h; solidity mirror
contrib/template.sol:267-307).  The transcript only hashes a few KiB per
proof, so a pure-python implementation is fast enough; a C fallback can be
added later if profiling ever shows otherwise.

NOTE: hashlib's sha3_256 is NIST SHA-3 (domain byte 0x06) and produces
different digests; Ethereum/keccak uses 0x01 padding, implemented here.
"""

_ROTC = [
    (0, 0), (1, 1), (2, 62), (3, 28), (4, 27),
    (5, 36), (6, 44), (7, 6), (8, 55), (9, 20),
    (10, 3), (11, 10), (12, 43), (13, 25), (14, 39),
    (15, 41), (16, 45), (17, 15), (18, 21), (19, 8),
    (20, 18), (21, 2), (22, 61), (23, 56), (24, 14),
]

_RC = [
    0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
    0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
    0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
    0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
    0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
    0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008,
]

_MASK = (1 << 64) - 1


def _rotl(x, n):
    return ((x << n) | (x >> (64 - n))) & _MASK


def _keccak_f(state):
    for rc in _RC:
        # theta
        c = [state[x] ^ state[x + 5] ^ state[x + 10] ^ state[x + 15] ^ state[x + 20] for x in range(5)]
        d = [c[(x - 1) % 5] ^ _rotl(c[(x + 1) % 5], 1) for x in range(5)]
        for x in range(5):
            dx = d[x]
            for y in range(0, 25, 5):
                state[x + y] ^= dx
        # rho + pi
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                # lane (x, y) at index x + 5y moves to (y, 2x+3y)
                b[y + 5 * ((2 * x + 3 * y) % 5)] = _rotl(state[x + 5 * y], _ROT[x + 5 * y])
        # chi
        for y in range(0, 25, 5):
            t = b[y:y + 5]
            for x in range(5):
                state[x + y] = t[x] ^ ((~t[(x + 1) % 5]) & t[(x + 2) % 5])
        # iota
        state[0] ^= rc
    return state


# rotation offsets laid out by lane index x + 5y
_ROT = [0] * 25
_ROT[0] = 0
_x, _y = 1, 0
_t_val = 0
for _t_val in range(24):
    _ROT[_x + 5 * _y] = ((_t_val + 1) * (_t_val + 2) // 2) % 64
    _x, _y = _y, (2 * _x + 3 * _y) % 5


def keccak256(data: bytes) -> bytes:
    rate = 136  # 1088-bit rate for keccak-256
    state = [0] * 25
    # pad10*1 with keccak domain bit 0x01
    padded = bytearray(data)
    pad_len = rate - (len(padded) % rate)
    padded += b"\x01" + b"\x00" * (pad_len - 2) + b"\x80" if pad_len >= 2 else b"\x81"
    for block_start in range(0, len(padded), rate):
        block = padded[block_start:block_start + rate]
        for i in range(rate // 8):
            state[i] ^= int.from_bytes(block[8 * i:8 * i + 8], "little")
        _keccak_f(state)
    out = b"".join(state[i].to_bytes(8, "little") for i in range(4))
    return out
