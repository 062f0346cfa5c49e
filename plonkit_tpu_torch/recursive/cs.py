"""Constraint-system builder + base gadget layer for directly-synthesized
circuits over the extended gate system (plonk.extended).

This plays the role of bellman_ce's better_better_cs ConstraintSystem +
franklin-crypto's basic gadgets (allocation, linear combinations, booleans,
selects) that the reference's aggregation circuit is written against
(plonkit's src/recursive/mod.rs:90-125, SURVEY D1i/D2).  Synthesis is
TrivialAssembly-style: every variable's value is computed eagerly at
allocation, so one pass yields gates + witness together.

Conventions:
  * variable 0 is the dummy wire (value 0, excluded from copy constraints);
  * gadgets never use q_dnext directly -- multi-term linear combinations
    chain through explicit accumulator variables, so gates stay
    row-independent; the only next-row coupling is inside range chains;
  * every range chain ends with a landing row whose d-cell holds the
    range-checked variable, so chains compose safely and the final
    accumulator is pinned by the C4 transition into the landing row.
"""

from typing import List, Sequence, Tuple

from ..fields import FR_MODULUS as R

ZEROS8 = (0, 0, 0, 0, 0, 0, 0, 0)


class Num:
    """A circuit variable handle: index + eagerly-computed witness value."""
    __slots__ = ("idx", "value")

    def __init__(self, idx: int, value: int):
        self.idx = idx
        self.value = value

    def __repr__(self):
        return f"Num({self.idx}, {self.value})"


class CsBuilder:
    def __init__(self):
        self.values: List[int] = [0]          # var 0 = dummy
        self.input_vars: List[int] = []
        self.wires: List[Tuple[int, int, int, int]] = []
        self.sels: List[Tuple[int, ...]] = []
        self._sel_cache = {ZEROS8: ZEROS8}
        self._const_cache = {}
        self.zero = self.constant(0)
        self.one = self.constant(1)

    # ---- core ----------------------------------------------------------

    def alloc(self, value: int) -> Num:
        value %= R
        self.values.append(value)
        return Num(len(self.values) - 1, value)

    def alloc_input(self, value: int) -> Num:
        n = self.alloc(value)
        self.input_vars.append(n.idx)
        return n

    def gate(self, a: int, b: int, c: int, d: int,
             qa=0, qb=0, qc=0, qd=0, qm=0, qconst=0, qdn=0, qr=0):
        key = (qa % R, qb % R, qc % R, qd % R, qm % R, qconst % R, qdn % R, qr % R)
        sel = self._sel_cache.get(key)
        if sel is None:
            sel = key
            self._sel_cache[key] = sel
        self.wires.append((a, b, c, d))
        self.sels.append(sel)

    @property
    def num_gates(self) -> int:
        return len(self.wires)

    # ---- constants / linear algebra --------------------------------------

    def constant(self, c: int) -> Num:
        c %= R
        hit = self._const_cache.get(c)
        if hit is not None:
            return hit
        n = self.alloc(c)
        # a - c = 0
        self.gate(n.idx, 0, 0, 0, qa=1, qconst=R - c if c else 0)
        self._const_cache[c] = n
        return n

    def enforce_lc(self, terms: Sequence[Tuple[Num, int]], constant: int = 0):
        """sum coeff_i * x_i + constant == 0."""
        terms = [(x, k % R) for (x, k) in terms if k % R]
        constant %= R
        if not terms:
            assert constant == 0, "unsatisfiable constant constraint"
            return
        # first gate takes up to 4 terms; continuation gates take 3 new
        # terms + the running accumulator.
        while len(terms) > 4:
            t0, t1, t2 = terms[0], terms[1], terms[2]
            acc_val = (t0[0].value * t0[1] + t1[0].value * t1[1]
                       + t2[0].value * t2[1]) % R
            acc = self.alloc(acc_val)
            self.gate(t0[0].idx, t1[0].idx, t2[0].idx, acc.idx,
                      qa=t0[1], qb=t1[1], qc=t2[1], qd=R - 1)
            terms = [(acc, 1)] + terms[3:]
        ws = [t[0].idx for t in terms] + [0] * (4 - len(terms))
        qs = [t[1] for t in terms] + [0] * (4 - len(terms))
        self.gate(ws[0], ws[1], ws[2], ws[3],
                  qa=qs[0], qb=qs[1], qc=qs[2], qd=qs[3], qconst=constant)

    def lc(self, terms: Sequence[Tuple[Num, int]], constant: int = 0) -> Num:
        """Allocate out = sum coeff_i * x_i + constant."""
        val = (sum(x.value * k for x, k in terms) + constant) % R
        out = self.alloc(val)
        self.enforce_lc(list(terms) + [(out, R - 1)], constant)
        return out

    def add(self, x: Num, y: Num) -> Num:
        return self.lc([(x, 1), (y, 1)])

    def sub(self, x: Num, y: Num) -> Num:
        return self.lc([(x, 1), (y, R - 1)])

    def mul(self, x: Num, y: Num) -> Num:
        out = self.alloc(x.value * y.value % R)
        self.gate(x.idx, y.idx, out.idx, 0, qm=1, qc=R - 1)
        return out

    def mul_add(self, x: Num, y: Num, z: Num, k: int = 1) -> Num:
        """out = x*y + k*z (one gate)."""
        out = self.alloc((x.value * y.value + k * z.value) % R)
        self.gate(x.idx, y.idx, z.idx, out.idx, qm=1, qc=k, qd=R - 1)
        return out

    def enforce_equal(self, x: Num, y: Num):
        self.gate(x.idx, y.idx, 0, 0, qa=1, qb=R - 1)

    def enforce_constant(self, x: Num, c: int):
        self.gate(x.idx, 0, 0, 0, qa=1, qconst=R - (c % R) if c % R else 0)

    def enforce_zero_var(self, x: Num):
        self.gate(x.idx, 0, 0, 0, qa=1)

    def boolean(self, value: int) -> Num:
        """Allocate a witness bit with b^2 = b."""
        b = self.alloc(value & 1)
        self.gate(b.idx, b.idx, 0, 0, qm=1, qa=R - 1)
        return b

    def enforce_boolean(self, b: Num):
        self.gate(b.idx, b.idx, 0, 0, qm=1, qa=R - 1)

    def select(self, bit: Num, x: Num, y: Num) -> Num:
        """bit ? x : y  (bit must already be boolean-constrained)."""
        t = self.sub(x, y)
        return self.mul_add(bit, t, y)

    def inverse(self, x: Num) -> Num:
        """1/x; also proves x != 0."""
        assert x.value != 0, "inverse of zero during synthesis"
        inv = self.alloc(pow(x.value, -1, R))
        self.gate(x.idx, inv.idx, 0, 0, qm=1, qconst=R - 1)
        return inv

    def div(self, x: Num, y: Num) -> Num:
        """x / y; proves y != 0."""
        assert y.value != 0, "division by zero during synthesis"
        out = self.alloc(x.value * pow(y.value, -1, R) % R)
        # out * y - x = 0
        self.gate(out.idx, y.idx, x.idx, 0, qm=1, qc=R - 1)
        return out

    # ---- range chains (the custom gate) ---------------------------------

    def enforce_range(self, x: Num, width: int) -> List[Num]:
        """Constrain 0 <= x < 2^width EXACTLY (width must be even) via a
        two-bit-decomposition chain: 8 bits per row + 1 landing row.  When
        width is not a multiple of 8, the leading accumulators are pinned
        to the zero variable -- the remaining transitions can only build
        `width` bits, so no rounding slack leaks into bound tracking."""
        assert width > 0 and width % 2 == 0
        full = (width + 7) & ~7
        rows = full // 8
        pinned = (full - width) // 2   # leading chunks forced to zero
        v = x.value
        assert v < (1 << width), "range chain witness out of range"
        # accumulators acc_0 = 0 .. acc_{4*rows} = v (MSB-first chunks)
        accs = [self.zero]
        acc = 0
        for i in range(4 * rows):
            chunk = (v >> (full - 2 * (i + 1))) & 3 if i >= pinned else 0
            acc = 4 * acc + chunk
            if i == 4 * rows - 1:
                accs.append(x)      # final accumulator IS the variable
            elif i < pinned:
                accs.append(self.zero)
            else:
                accs.append(self.alloc(acc))
        assert acc == v
        for j in range(rows):
            a4 = accs[4 * j: 4 * j + 4]     # d, c, b, a cells
            self.gate(a4[3].idx, a4[2].idx, a4[1].idx, a4[0].idx, qr=1)
        # landing row: the C4 transition of the last range row reads this
        # row's d-cell, which must hold x
        self.gate(0, 0, 0, x.idx)
        return accs

    def decompose_chunks(self, x: Num, width: int) -> List[Num]:
        """Range-check x to `width` bits and return its 2-bit chunks
        MSB-first as constrained wires (chunk_i = acc_{i+1} - 4*acc_i)."""
        width = (width + 7) & ~7
        accs = self.enforce_range(x, width)
        chunks = []
        for i in range(len(accs) - 1):
            ch = self.lc([(accs[i + 1], 1), (accs[i], R - 4)])
            chunks.append(ch)
        return chunks

    # ---- finalize --------------------------------------------------------

    def setup(self, backend=None):
        from ..plonk.extended import make_setup_polynomials2
        return make_setup_polynomials2(
            len(self.input_vars), list(self.input_vars), self.wires, self.sels,
            backend=backend)

    def wire_columns(self) -> List[List[int]]:
        vals = self.values
        cols = [[], [], [], []]
        for v in self.input_vars:
            cols[0].append(vals[v])
            cols[1].append(0)
            cols[2].append(0)
            cols[3].append(0)
        for (a, b, c, d) in self.wires:
            cols[0].append(vals[a])
            cols[1].append(vals[b])
            cols[2].append(vals[c])
            cols[3].append(vals[d])
        return cols

    def public_inputs(self) -> List[int]:
        return [self.values[v] for v in self.input_vars]
