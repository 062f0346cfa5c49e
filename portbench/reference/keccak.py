"""Keccak-256 (Ethereum's padding, not NIST SHA-3) and the rolling keccak
Fiat-Shamir transcript of plonkit's keccak proofs (bellman_ce's
RollingKeccakTranscript): two chained states and a challenge counter,
values as 32-byte big-endian words, tags and counter as 4-byte words.
Written for the plain reference; it imports nothing of the program."""

_MASK = (1 << 64) - 1
_RC = [0x0000000000000001, 0x0000000000008082, 0x800000000000808A, 0x8000000080008000,
       0x000000000000808B, 0x0000000080000001, 0x8000000080008081, 0x8000000000008009,
       0x000000000000008A, 0x0000000000000088, 0x0000000080008009, 0x000000008000000A,
       0x000000008000808B, 0x800000000000008B, 0x8000000000008089, 0x8000000000008003,
       0x8000000000008002, 0x8000000000000080, 0x000000000000800A, 0x800000008000000A,
       0x8000000080008081, 0x8000000000008080, 0x0000000080000001, 0x8000000080008008]


def _rotation_offsets():
    rot = [0] * 25
    x, y = 1, 0
    for t in range(24):
        rot[x + 5 * y] = ((t + 1) * (t + 2) // 2) % 64
        x, y = y, (2 * x + 3 * y) % 5
    return rot


_ROT = _rotation_offsets()


def _permute(a: list) -> None:
    for rc in _RC:
        c = [a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20] for x in range(5)]
        for x in range(5):
            d = c[(x - 1) % 5] ^ (((c[(x + 1) % 5] << 1) | (c[(x + 1) % 5] >> 63)) & _MASK)
            for y in range(0, 25, 5):
                a[x + y] ^= d
        b = [0] * 25
        for x in range(5):
            for y in range(5):
                v, n = a[x + 5 * y], _ROT[x + 5 * y]
                b[y + 5 * ((2 * x + 3 * y) % 5)] = ((v << n) | (v >> (64 - n))) & _MASK if n else v
        for y in range(0, 25, 5):
            row = b[y:y + 5]
            for x in range(5):
                a[x + y] = row[x] ^ (~row[(x + 1) % 5] & row[(x + 2) % 5])
        a[0] ^= rc


def keccak256(data: bytes) -> bytes:
    rate = 136
    msg = bytearray(data) + b"\x01"
    msg += b"\x00" * (-len(msg) % rate)
    msg[-1] |= 0x80
    a = [0] * 25
    for off in range(0, len(msg), rate):
        for i in range(rate // 8):
            a[i] ^= int.from_bytes(msg[off + 8 * i:off + 8 * i + 8], "little")
        _permute(a)
    return b"".join(a[i].to_bytes(8, "little") for i in range(4))


class Transcript:
    """update(v): s0' = H(0 || s0 || s1 || v), s1' = H(1 || s0 || s1 || v);
    challenge: H(2 || s0 || s1 || counter) with its top three bits cleared."""

    def __init__(self):
        self.s0 = self.s1 = bytes(32)
        self.counter = 0

    def update(self, value: int) -> None:
        v = value.to_bytes(32, "big")
        s0, s1 = self.s0, self.s1
        self.s0 = keccak256(b"\x00\x00\x00\x00" + s0 + s1 + v)
        self.s1 = keccak256(b"\x00\x00\x00\x01" + s0 + s1 + v)

    def update_point(self, p) -> None:
        for c in (0, 0) if p is None else p:
            self.update(c)

    def challenge(self) -> int:
        h = keccak256(b"\x00\x00\x00\x02" + self.s0 + self.s1 + self.counter.to_bytes(4, "big"))
        self.counter += 1
        return int.from_bytes(h, "big") & ((1 << 253) - 1)
