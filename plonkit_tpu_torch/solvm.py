"""Execute the rendered Solidity verifiers without solc or an EVM: the
port's copy of plonkit_tpu/solvm.py.

What runs is the contract text that `generate-verifier` and
`generate-recursive-verifier` write, parsed by a recursive-descent parser
and walked by an evaluator for the Solidity subset the two templates
(data/template.sol, data/recursive_template.sol) use: uint256/bytes32
constants, structs, internal/public functions (named and positional
returns, tuple returns), memory structs and fixed/dynamic arrays
(reference semantics), for/if/require/return, addmod/mulmod/keccak256/
abi.encodePacked, integer casts, array literals, `new uint256[](n)`, and
the one `assembly { ok := staticcall(...) }` pattern.  A codegen fault
(a wrong vk constant, a broken transcript mirror, a bad Rescue literal)
fails here as it would on chain.

The EVM precompiles the contracts staticcall: 0x05 modexp, 0x06 ecAdd
and 0x07 ecMul on curve.py (an off-curve point reverts), 0x08 pairing on
native.bn254_pairing_check (EVM G2 words (im, re); a pair with a point
at infinity is skipped, since e(inf, Q) = e(P, inf) = 1).

Arithmetic is checked, as solc 0.8 compiles it outside an `unchecked`
block (the reference harness compiles with solc 0.8.4; neither template
has such a block and both pragmas allow <0.9.0): `+`, `-`, `*`, their
compound assignments and `++`/`--` revert (SolRevert) on overflow and
underflow; division and modulo by zero revert; explicit integer casts
truncate.  This differs from plonkit_tpu/solvm.py, which wraps modulo
2^256.  Arithmetic is at 256 bits whatever the declared width.

contract.py runs a verifier on a proof and on tampered copies of it.
"""

import re
from typing import Dict, List, Optional

from .keccak import keccak256

WORD = (1 << 256) - 1


class SolRevert(Exception):
    pass


# --------------------------------------------------------------- tokenizer

_TOKEN_RE = re.compile(r"""
    (?P<ws>\s+|//[^\n]*|/\*.*?\*/)
  | (?P<hex>0x[0-9a-fA-F]+)
  | (?P<num>\d+)
  | (?P<str>"(?:[^"\\]|\\.)*")
  | (?P<id>[A-Za-z_$][A-Za-z0-9_$]*)
  | (?P<op>\+\+|--|\*\*|<<|>>|<=|>=|==|!=|&&|\|\||\+=|-=|\*=|/=|%=|\|=|&=|\^=|:=|[-+*/%<>=!&|^~?:;,.(){}\[\]])
""", re.VERBOSE | re.DOTALL)


def tokenize(src: str) -> List[str]:
    out = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"solvm: bad token at {src[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup != "ws":
            out.append(m.group())
    return out


# ------------------------------------------------------------------- types

ELEM_TYPES = {"bool": 1}
for _n in range(8, 257, 8):
    ELEM_TYPES[f"uint{_n}"] = _n
ELEM_TYPES["uint"] = 256
for _n in range(1, 33):
    ELEM_TYPES[f"bytes{_n}"] = _n * 8


class ArrayType:
    def __init__(self, elem, length=None):
        self.elem = elem          # type name or ArrayType
        self.length = length      # None = dynamic

    def __repr__(self):
        return f"{self.elem}[{self.length if self.length is not None else ''}]"


class StructVal:
    __slots__ = ("name", "fields")

    def __init__(self, name, fields):
        self.name = name
        self.fields = fields      # dict field -> value


class Parser:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k] if self.i + k < len(self.toks) else None

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, t):
        got = self.next()
        if got != t:
            raise SyntaxError(f"solvm: expected {t!r}, got {got!r} near "
                              f"{' '.join(self.toks[self.i-4:self.i+4])}")
        return got

    def accept(self, t):
        if self.peek() == t:
            self.next()
            return True
        return False

    # -- top level ---------------------------------------------------------

    def parse_contract(self):
        while self.peek() != "contract":
            if self.peek() == "pragma":
                while self.next() != ";":
                    pass
            else:
                self.next()
        self.expect("contract")
        name = self.next()
        self.expect("{")
        consts, structs, funcs = [], {}, {}
        while self.peek() != "}":
            if self.peek() == "struct":
                self.next()
                sname = self.next()
                self.expect("{")
                fields = []
                while self.peek() != "}":
                    ftype = self.parse_type()
                    fname = self.next()
                    self.expect(";")
                    fields.append((ftype, fname))
                self.expect("}")
                structs[sname] = fields
            elif self.peek() == "function":
                f = self.parse_function()
                funcs[f["name"]] = f
            else:
                # constant declaration: type ["constant"] name = expr ;
                ctype = self.parse_type()
                assert self.accept("constant"), "only constant state allowed"
                cname = self.next()
                self.expect("=")
                cexpr = self.parse_expr()
                self.expect(";")
                consts.append((ctype, cname, cexpr))
        return {"name": name, "consts": consts, "structs": structs,
                "funcs": funcs}

    def parse_type(self):
        t = self.next()
        while self.peek() == "[":
            self.next()
            if self.peek() == "]":
                ln = None
            else:
                tok = self.next()
                # lengths may be numeric or a named constant (resolved
                # against the contract's constants at allocation time)
                ln = int(tok, 0) if tok[0].isdigit() else tok
            self.expect("]")
            t = ArrayType(t, ln)
        return t

    def _skip_loc(self):
        while self.peek() in ("memory", "calldata", "storage"):
            self.next()

    def parse_function(self):
        self.expect("function")
        name = self.next()
        self.expect("(")
        params = []
        while self.peek() != ")":
            ptype = self.parse_type()
            self._skip_loc()
            params.append((ptype, self.next()))
            if self.peek() == ",":
                self.next()
        self.expect(")")
        rets = []
        while self.peek() not in ("{", ";"):
            if self.peek() == "returns":
                self.next()
                self.expect("(")
                while self.peek() != ")":
                    rtype = self.parse_type()
                    self._skip_loc()
                    rname = None
                    if self.peek() not in (",", ")"):
                        rname = self.next()
                    rets.append((rtype, rname))
                    if self.peek() == ",":
                        self.next()
                self.expect(")")
            else:
                self.next()  # visibility / mutability keywords
        body = self.parse_block()
        return {"name": name, "params": params, "rets": rets, "body": body}

    # -- statements --------------------------------------------------------

    def parse_block(self):
        self.expect("{")
        stmts = []
        while self.peek() != "}":
            stmts.append(self.parse_stmt())
        self.expect("}")
        return ("block", stmts)

    def _is_type_start(self):
        t = self.peek()
        if t in ELEM_TYPES or t == "bool":
            return True
        # struct type followed by "memory name" or "[...]" or bare name =
        if t and re.match(r"^[A-Za-z_$]", t):
            n1 = self.peek(1)
            if n1 == "memory":
                return True
            if n1 == "[":
                # distinguish indexing (expr) from type: Type[] / Type[3] mem
                n2 = self.peek(2)
                if n2 == "]" or (n2 and n2.isdigit() and self.peek(3) == "]"):
                    # could still be indexing arr[3] = ...; require following
                    j = 2
                    while self.toks[self.i + j] != "]":
                        j += 1
                    after = self.toks[self.i + j + 1]
                    return after in ("memory", "calldata") or re.match(
                        r"^[A-Za-z_$]", after) and self.toks[self.i + j + 2] \
                        in ("=", ";")
        return False

    def parse_stmt(self):
        t = self.peek()
        if t == "{":
            return self.parse_block()
        if t == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            els = None
            if self.accept("else"):
                els = self.parse_stmt()
            return ("if", cond, then, els)
        if t == "for":
            self.next()
            self.expect("(")
            init = self.parse_stmt()          # consumes the ';'
            cond = self.parse_expr()
            self.expect(";")
            post = self.parse_simple_stmt()
            self.expect(")")
            body = self.parse_stmt()
            return ("for", init, cond, post, body)
        if t == "return":
            self.next()
            if self.peek() == ";":
                self.next()
                return ("return", None)
            e = self.parse_expr_list_maybe_tuple()
            self.expect(";")
            return ("return", e)
        if t == "require":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            msg = "require failed"
            if self.accept(","):
                msg = self.next().strip('"')
            self.expect(")")
            self.expect(";")
            return ("require", cond, msg)
        if t == "assembly":
            self.next()
            self.expect("{")
            depth = 1
            raw = []
            while depth:
                tok = self.next()
                if tok == "{":
                    depth += 1
                elif tok == "}":
                    depth -= 1
                if depth:
                    raw.append(tok)
            return ("assembly", raw)
        if t == "(":
            # tuple assignment: (a, b) = f(...);  declarations allowed inside
            self.next()
            targets = []
            while self.peek() != ")":
                if self._is_type_start():
                    ttype = self.parse_type()
                    self._skip_loc()
                    targets.append(("decl", ttype, self.next()))
                else:
                    targets.append(("lv", self.parse_expr()))
                if self.peek() == ",":
                    self.next()
            self.expect(")")
            self.expect("=")
            rhs = self.parse_expr()
            self.expect(";")
            return ("tuple_assign", targets, rhs)
        stmt = self.parse_simple_stmt()
        self.expect(";")
        return stmt

    def parse_simple_stmt(self):
        if self._is_type_start():
            vtype = self.parse_type()
            self._skip_loc()
            name = self.next()
            init = None
            if self.accept("="):
                init = self.parse_expr()
            return ("decl", vtype, name, init)
        e = self.parse_expr()
        if self.peek() in ("=", "+=", "-=", "*=", "/=", "%=", "|=", "&=", "^="):
            op = self.next()
            rhs = self.parse_expr()
            return ("assign", e, op, rhs)
        return ("expr", e)

    def parse_expr_list_maybe_tuple(self):
        if self.peek() == "(":
            save = self.i
            self.next()
            exprs = [self.parse_expr()]
            if self.peek() == ",":
                while self.accept(","):
                    exprs.append(self.parse_expr())
                self.expect(")")
                return ("tuple", exprs)
            self.i = save
        return self.parse_expr()

    # -- expressions (precedence climbing) --------------------------------

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        c = self.parse_or()
        if self.accept("?"):
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_expr()
            return ("cond", c, a, b)
        return c

    def _binop_level(self, sub, ops):
        e = sub()
        while self.peek() in ops:
            op = self.next()
            e = ("bin", op, e, sub())
        return e

    def parse_or(self):
        return self._binop_level(self.parse_and, ("||",))

    # Solidity precedence (0.8.x, loosest to tightest): || > && > == != >
    # < > <= >= > | > ^ > & > << >> > + - > * / % — bitwise operators bind
    # TIGHTER than comparisons, the opposite of C, so an unparenthesized
    # `a & b == c` must parse as `(a & b) == c`.
    def parse_and(self):
        return self._binop_level(self.parse_eq, ("&&",))

    def parse_eq(self):
        return self._binop_level(self.parse_rel, ("==", "!="))

    def parse_rel(self):
        return self._binop_level(self.parse_bitor, ("<", ">", "<=", ">="))

    def parse_bitor(self):
        return self._binop_level(self.parse_bitxor, ("|",))

    def parse_bitxor(self):
        return self._binop_level(self.parse_bitand, ("^",))

    def parse_bitand(self):
        return self._binop_level(self.parse_shift, ("&",))

    def parse_shift(self):
        return self._binop_level(self.parse_add, ("<<", ">>"))

    def parse_add(self):
        return self._binop_level(self.parse_mul_, ("+", "-"))

    def parse_mul_(self):
        return self._binop_level(self.parse_unary, ("*", "/", "%"))

    def parse_unary(self):
        t = self.peek()
        if t in ("!", "-", "~"):
            self.next()
            return ("un", t, self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        e = self.parse_primary()
        while True:
            t = self.peek()
            if t == "(":
                self.next()
                args = []
                while self.peek() != ")":
                    args.append(self.parse_expr())
                    if self.peek() == ",":
                        self.next()
                self.expect(")")
                e = ("call", e, args)
            elif t == "[":
                self.next()
                idx = self.parse_expr()
                self.expect("]")
                e = ("index", e, idx)
            elif t == ".":
                self.next()
                e = ("member", e, self.next())
            elif t == "++":
                self.next()
                e = ("postinc", e)
            elif t == "--":
                self.next()
                e = ("postdec", e)
            else:
                return e

    def parse_primary(self):
        t = self.next()
        if t == "(":
            e = self.parse_expr()
            self.expect(")")
            return e
        if t == "[":
            elems = []
            while self.peek() != "]":
                elems.append(self.parse_expr())
                if self.peek() == ",":
                    self.next()
            self.expect("]")
            return ("arraylit", elems)
        if t == "new":
            ntype = self.parse_type()
            self.expect("(")
            n = self.parse_expr()
            self.expect(")")
            return ("new_array", ntype, n)
        if t.startswith("0x"):
            return ("num", int(t, 16))
        if t.isdigit():
            return ("num", int(t))
        if t.startswith('"'):
            return ("str", t.strip('"'))
        if t == "true":
            return ("num", 1)
        if t == "false":
            return ("num", 0)
        return ("id", t)


# --------------------------------------------------------------- evaluator

def _checked(v: int) -> int:
    """A uint256 result of +, - or *: solc 0.8 reverts where it leaves
    [0, 2^256)."""
    if v < 0 or v > WORD:
        raise SolRevert("arithmetic overflow or underflow")
    return v


class _Ret(Exception):
    def __init__(self, vals):
        self.vals = vals


def _default(itp, t):
    if isinstance(t, ArrayType):
        if t.length is None:
            return []
        ln = itp.consts[t.length] if isinstance(t.length, str) else t.length
        return [_default(itp, t.elem) for _ in range(ln)]
    if t in ELEM_TYPES:
        return 0
    if t in itp.structs:
        return StructVal(t, {fn: _default(itp, ft)
                             for ft, fn in itp.structs[t]})
    raise SolRevert(f"unknown type {t}")


def _width(itp, tname) -> Optional[int]:
    """Byte width for abi.encodePacked."""
    if tname in ELEM_TYPES:
        if tname == "bool":
            return 1
        return ELEM_TYPES[tname] // 8
    return None


class Interpreter:
    def __init__(self, source: str, precompiles=None):
        self.ast = Parser(tokenize(source)).parse_contract()
        self.structs = self.ast["structs"]
        self.funcs = self.ast["funcs"]
        self.consts: Dict[str, int] = {}
        self.const_types: Dict[str, object] = {}
        self.precompiles = precompiles or default_precompiles()
        for ctype, cname, cexpr in self.ast["consts"]:
            self.consts[cname] = self._eval(cexpr, {})
            self.const_types[cname] = ctype

    # -- public API --------------------------------------------------------

    def call(self, fname: str, *args):
        """Call a contract function with python ints / lists."""
        f = self.funcs[fname]
        if len(args) != len(f["params"]):
            raise TypeError(f"{fname} takes {len(f['params'])} arguments, got {len(args)}")
        env = {}
        for (ptype, pname), a in zip(f["params"], args):
            env[pname] = self._ingest(ptype, a)
            env[("type", pname)] = ptype
        return self._run_function(f, env)

    def _ingest(self, t, a):
        if isinstance(a, StructVal):
            return a          # re-entrant calls with contract-built structs
        if isinstance(t, ArrayType):
            return [self._ingest(t.elem, x) for x in a]
        return int(a)

    def _run_function(self, f, env):
        for rtype, rname in f["rets"]:
            if rname:
                env[rname] = _default(self, rtype)
                env[("type", rname)] = rtype
        try:
            self._exec(f["body"], env)
        except _Ret as r:
            if r.vals is not None:
                return r.vals
        named = [env[rname] for _, rname in f["rets"] if rname]
        if len(named) == len(f["rets"]) and named:
            return named[0] if len(named) == 1 else tuple(named)
        if f["rets"]:
            raise SolRevert(f"{f['name']}: fell off end without return")
        return None

    # -- statements --------------------------------------------------------

    def _exec(self, stmt, env):
        kind = stmt[0]
        if kind == "block":
            for s in stmt[1]:
                self._exec(s, env)
        elif kind == "decl":
            _, vtype, name, init = stmt
            env[name] = self._eval(init, env) if init is not None \
                else _default(self, vtype)
            env[("type", name)] = vtype
        elif kind == "assign":
            _, lv, op, rhs = stmt
            val = self._eval(rhs, env)
            if op != "=":
                cur = self._eval(lv, env)
                val = self._arith(op[0], cur, val)
            self._store(lv, val, env)
        elif kind == "tuple_assign":
            _, targets, rhs = stmt
            vals = self._eval(rhs, env)
            if not isinstance(vals, tuple):
                vals = (vals,)
            assert len(vals) == len(targets)
            for tgt, v in zip(targets, vals):
                if tgt[0] == "decl":
                    env[tgt[2]] = v
                    env[("type", tgt[2])] = tgt[1]
                else:
                    self._store(tgt[1], v, env)
        elif kind == "if":
            _, cond, then, els = stmt
            if self._eval(cond, env):
                self._exec(then, env)
            elif els is not None:
                self._exec(els, env)
        elif kind == "for":
            _, init, cond, post, body = stmt
            self._exec(init, env)
            while self._eval(cond, env):
                self._exec(body, env)
                self._exec(post, env)
        elif kind == "return":
            e = stmt[1]
            if e is None:
                raise _Ret(None)
            if e[0] == "tuple":
                raise _Ret(tuple(self._eval(x, env) for x in e[1]))
            raise _Ret(self._eval(e, env))
        elif kind == "require":
            _, cond, msg = stmt
            if not self._eval(cond, env):
                raise SolRevert(msg)
        elif kind == "expr":
            self._eval(stmt[1], env)
        elif kind == "assembly":
            self._exec_assembly(stmt[1], env)
        else:
            raise SolRevert(f"unhandled stmt {kind}")

    def _exec_assembly(self, raw, env):
        """Only the `ok := staticcall(gas(), ADDR, in, insz, out, outsz)`
        pattern is supported — the templates use assembly for nothing else."""
        text = " ".join(raw)
        m = re.match(
            r"^(\w+) := staticcall \( gas \( \) , (0x[0-9a-fA-F]+) , "
            r"(\w+) , 0x[0-9a-fA-F]+ , (\w+) , 0x[0-9a-fA-F]+ \)$", text)
        if not m:
            raise SolRevert(f"unsupported assembly: {text}")
        okvar, addr, invar, outvar = m.group(1), int(m.group(2), 16), \
            m.group(3), m.group(4)
        words = list(env[invar])
        ok, out_words = self.precompiles(addr, words)
        env[okvar] = 1 if ok else 0
        tgt = env[outvar]
        if isinstance(tgt, StructVal):
            names = list(tgt.fields)
            for name, w in zip(names, out_words):
                tgt.fields[name] = w
        else:
            for i, w in enumerate(out_words):
                tgt[i] = w

    # -- lvalue store ------------------------------------------------------

    def _store(self, lv, val, env):
        if lv[0] == "id":
            env[lv[1]] = val
        elif lv[0] == "member":
            obj = self._eval(lv[1], env)
            obj.fields[lv[2]] = val
        elif lv[0] == "index":
            arr = self._eval(lv[1], env)
            arr[self._eval(lv[2], env)] = val
        else:
            raise SolRevert(f"bad lvalue {lv[0]}")

    # -- expressions -------------------------------------------------------

    def _arith(self, op, a, b):
        if op in ("+", "-", "*"):
            return _checked(a + b if op == "+" else a - b if op == "-" else a * b)
        if op == "/":
            if b == 0:
                raise SolRevert("division by zero")
            return a // b
        if op == "%":
            if b == 0:
                raise SolRevert("mod by zero")
            return a % b
        if op == "|":
            return a | b
        if op == "&":
            return a & b
        if op == "^":
            return a ^ b
        raise SolRevert(f"bad op {op}")

    def _expr_type(self, e, env):
        """Static-ish type of an expression (for abi.encodePacked widths)."""
        if e[0] == "id":
            t = env.get(("type", e[1]))
            if t is None and e[1] in self.const_types:
                t = self.const_types[e[1]]
            return t
        if e[0] == "call" and e[1][0] == "id" and e[1][1] in ELEM_TYPES:
            return e[1][1]
        if e[0] == "member":
            base_t = self._expr_type(e[1], env)
            if isinstance(base_t, str) and base_t in self.structs:
                for ft, fn in self.structs[base_t]:
                    if fn == e[2]:
                        return ft
        if e[0] == "index":
            base_t = self._expr_type(e[1], env)
            if isinstance(base_t, ArrayType):
                return base_t.elem
        if e[0] == "num":
            return "uint256"
        return "uint256"

    def _encode_packed(self, args, env) -> bytes:
        out = b""
        for a in args:
            v = self._eval(a, env)
            t = self._expr_type(a, env)
            w = _width(self, t if isinstance(t, str) else "uint256") or 32
            out += int(v).to_bytes(w, "big")
        return out

    def _eval(self, e, env):
        kind = e[0]
        if kind == "num":
            return e[1]
        if kind == "str":
            return e[1]
        if kind == "id":
            name = e[1]
            if name in env:
                return env[name]
            if name in self.consts:
                return self.consts[name]
            raise SolRevert(f"unknown identifier {name}")
        if kind == "bin":
            op = e[1]
            if op == "&&":
                return 1 if (self._eval(e[2], env) and
                             self._eval(e[3], env)) else 0
            if op == "||":
                return 1 if (self._eval(e[2], env) or
                             self._eval(e[3], env)) else 0
            a = self._eval(e[2], env)
            b = self._eval(e[3], env)
            if op == "==":
                return 1 if a == b else 0
            if op == "!=":
                return 1 if a != b else 0
            if op == "<":
                return 1 if a < b else 0
            if op == ">":
                return 1 if a > b else 0
            if op == "<=":
                return 1 if a <= b else 0
            if op == ">=":
                return 1 if a >= b else 0
            if op == "<<":
                return (a << b) & WORD
            if op == ">>":
                return a >> b
            return self._arith(op, a, b)
        if kind == "un":
            v = self._eval(e[2], env)
            if e[1] == "!":
                return 0 if v else 1
            if e[1] == "-":
                return (-v) & WORD
            if e[1] == "~":
                return (~v) & WORD
        if kind == "cond":
            return self._eval(e[2], env) if self._eval(e[1], env) \
                else self._eval(e[3], env)
        if kind in ("postinc", "postdec"):
            cur = self._eval(e[1], env)
            self._store(e[1], _checked(cur + 1 if kind == "postinc" else cur - 1), env)
            return cur
        if kind == "member":
            base = self._eval(e[1], env)
            if e[2] == "length":
                return len(base)
            return base.fields[e[2]]
        if kind == "index":
            arr = self._eval(e[1], env)
            i = self._eval(e[2], env)
            if i >= len(arr):
                raise SolRevert("index out of bounds")
            return arr[i]
        if kind == "arraylit":
            return [self._eval(x, env) for x in e[1]]
        if kind == "new_array":
            n = self._eval(e[2], env)
            return [_default(self, e[1].elem) for _ in range(n)]
        if kind == "call":
            return self._call_expr(e, env)
        raise SolRevert(f"unhandled expr {kind}")

    def _call_expr(self, e, env):
        callee, args = e[1], e[2]
        if callee[0] == "member" and callee[1] == ("id", "abi") \
                and callee[2] == "encodePacked":
            return self._encode_packed(args, env)
        if callee[0] != "id":
            raise SolRevert("computed call targets unsupported")
        name = callee[1]
        if name == "keccak256":
            data = self._eval(args[0], env)
            assert isinstance(data, bytes)
            return int.from_bytes(keccak256(data), "big")
        if name == "addmod":
            a, b, m = (self._eval(x, env) for x in args)
            if m == 0:
                raise SolRevert("addmod by zero")
            return (a + b) % m
        if name == "mulmod":
            a, b, m = (self._eval(x, env) for x in args)
            if m == 0:
                raise SolRevert("mulmod by zero")
            return (a * b) % m
        if name in ELEM_TYPES:
            v = self._eval(args[0], env)
            bits = ELEM_TYPES[name]
            return int(v) & ((1 << bits) - 1)
        if name in self.structs:
            fields = self.structs[name]
            assert len(args) == len(fields)
            return StructVal(name, {fn: self._eval(a, env)
                                    for (ft, fn), a in zip(fields, args)})
        if name in self.funcs:
            f = self.funcs[name]
            assert len(args) == len(f["params"]), name
            fenv = {}
            for (ptype, pname), a in zip(f["params"], args):
                fenv[pname] = self._eval(a, env)
                fenv[("type", pname)] = ptype
            return self._run_function(f, fenv)
        raise SolRevert(f"unknown function {name}")


# ------------------------------------------------------------- precompiles

def default_precompiles():
    """EVM precompiles 0x05-0x08 on the port's host curve code and the
    native pairing."""
    from .curve import g1_add as _g1_add, g1_is_on_curve, g1_mul as _g1_mul
    from .native import bn254_pairing_check

    def to_pt(x, y):
        if x == 0 and y == 0:
            return None
        p = (x, y)
        if not g1_is_on_curve(p):
            raise SolRevert("point not on curve (precompile)")
        return p

    def from_pt(p):
        return [0, 0] if p is None else [p[0], p[1]]

    def run(addr, words):
        if addr == 0x05:
            blen, elen, mlen = words[0], words[1], words[2]
            if (blen, elen, mlen) != (32, 32, 32):
                raise SolRevert("modexp: only 32-byte operands")
            base, exp, mod = words[3], words[4], words[5]
            return True, [pow(base, exp, mod) if mod else 0]
        if addr == 0x06:
            p = to_pt(words[0], words[1])
            q = to_pt(words[2], words[3])
            return True, from_pt(_g1_add(p, q))
        if addr == 0x07:
            p = to_pt(words[0], words[1])
            return True, from_pt(_g1_mul(p, words[2]))
        if addr == 0x08:
            if len(words) % 6:
                raise SolRevert("pairing: input not a multiple of 6 words")
            pairs = []
            for i in range(0, len(words), 6):
                g1 = to_pt(words[i], words[i + 1])
                # EVM G2 encoding: x = x_im * i + x_re given as (im, re)
                x = (words[i + 3], words[i + 2])
                y = (words[i + 5], words[i + 4])
                g2 = None if all(v == 0 for v in x + y) else (x, y)
                if g1 is not None and g2 is not None:
                    pairs.append((g1, g2))   # e(inf, Q) = e(P, inf) = 1
            return True, [1 if bn254_pairing_check(pairs) else 0]
        raise SolRevert(f"unknown precompile {addr:#x}")

    return run
