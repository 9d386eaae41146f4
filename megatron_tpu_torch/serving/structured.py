"""Structured output: grammar-constrained decoding for the slot grid
(megatron_tpu/serving/structured.py, copied: the port keeps its own
copy of this NumPy/stdlib module and imports nothing of the JAX package).

SGLang (PAPERS.md) showed constrained decoding is a PER-STEP VOCAB
MASK problem: compile the grammar once into a finite-state machine
whose states each carry a precomputed [vocab] bitmask of legal next
tokens, then the hot loop does zero grammar work — it indexes a table.
This module is that compiler, host-side and engine-agnostic:

  response_format ──► char-level regex ──► Thompson NFA ──► subset-
  (regex / JSON        (JSON schemas       construction DFA (trimmed:
   schema subset)       lower to a          every surviving state can
                        regex)              still reach accept)
                                      ──► TokenFSM: tables composed
                                          over the TOKENIZER
                                            mask_table [states, V] bool
                                            next_table [states, V] i32
                                            accepting  [states]   bool

The engine (serving/engine.py) compiles one `TokenFSM` per structured
request AT ADMISSION, keeps the integer `fsm_state` on the request
(host-side — it survives preemption/park/resume and engine restarts
for free, exactly like the PRNG chain), and uploads the state's mask
row to the device only when the state CHANGES (`mask_uploads`). The
mask applies inside `sample_batched` at the same post-temperature/
top-k/top-p seam as the speculative `banned` point mask — a [V]
bitmask is the set generalization of banning one token — so decode
and verify keep their single compiled traces; draft tokens that
violate the grammar simply fail verify.

Everything here is NumPy + stdlib: no torch import, no device work.
Compile cost is paid once per request on the submit path (and shared
across an n-best fan-out's samples); the per-token cost is one table
row read.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


class GrammarCompileError(ValueError):
    """The response_format cannot be compiled into a usable FSM:
    malformed regex, unsupported JSON-schema construct, or a grammar
    that matches NO string at all (every path dead-ends). The HTTP
    layer maps this to 400 — it is a submit-time admission refusal,
    not a runtime failure."""


# ---------------------------------------------------------------------
# regex AST (recursive descent) — the deliberately tiny dialect the
# schema lowering needs: literals, escapes, classes [a-z^], dot,
# grouping, alternation, * + ? {m} {m,n}. No anchors (^/$ are
# implicit: the FSM always matches the WHOLE emitted text), no
# backrefs, no lookaround — those aren't regular and have no FSM.
# ---------------------------------------------------------------------
_MAX_CHAR = 0x100  # byte-sized alphabet; tokens compose strings over it
_DOT = frozenset(c for c in range(_MAX_CHAR) if c != 0x0A)
_ESCAPES = {
    "d": frozenset(range(ord("0"), ord("9") + 1)),
    "w": frozenset(list(range(ord("a"), ord("z") + 1))
                   + list(range(ord("A"), ord("Z") + 1))
                   + list(range(ord("0"), ord("9") + 1)) + [ord("_")]),
    "s": frozenset(map(ord, " \t\r\n")),
    "n": frozenset([0x0A]), "t": frozenset([0x09]),
    "r": frozenset([0x0D]),
}


class _RegexParser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str):
        raise GrammarCompileError(
            f"bad regex at position {self.i}: {msg} "
            f"(pattern {self.p!r})")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.peek()
        if c is None:
            self.error("unexpected end of pattern")
        self.i += 1
        return c

    def parse(self):
        node = self.alt()
        if self.i != len(self.p):
            self.error(f"unexpected {self.p[self.i]!r}")
        return node

    def alt(self):
        branches = [self.concat()]
        while self.peek() == "|":
            self.next()
            branches.append(self.concat())
        return branches[0] if len(branches) == 1 else ("alt", branches)

    def concat(self):
        parts = []
        while self.peek() is not None and self.peek() not in "|)":
            parts.append(self.repeat())
        if not parts:
            return ("eps",)
        return parts[0] if len(parts) == 1 else ("cat", parts)

    def repeat(self):
        node = self.atom()
        c = self.peek()
        if c == "*":
            self.next()
            return ("rep", node, 0, None)
        if c == "+":
            self.next()
            return ("rep", node, 1, None)
        if c == "?":
            self.next()
            return ("rep", node, 0, 1)
        if c == "{":
            self.next()
            m = self._int()
            n = m
            if self.peek() == ",":
                self.next()
                n = self._int() if self.peek() != "}" else None
            if self.next() != "}":
                self.error("expected }")
            if n is not None and n < m:
                self.error(f"bad repetition bounds {{{m},{n}}}")
            return ("rep", node, m, n)
        return node

    def _int(self) -> int:
        digits = ""
        while self.peek() is not None and self.peek().isdigit():
            digits += self.next()
        if not digits:
            self.error("expected integer")
        return int(digits)

    def atom(self):
        c = self.next()
        if c == "(":
            node = self.alt()
            if self.next() != ")":
                self.error("expected )")
            return node
        if c == "[":
            return ("lit", self._char_class())
        if c == ".":
            return ("lit", _DOT)
        if c == "\\":
            return ("lit", self._escape())
        if c in "*+?{":
            self.error(f"quantifier {c!r} with nothing to repeat")
        if c in ")]}":
            self.error(f"unbalanced {c!r}")
        return ("lit", frozenset([ord(c)]))

    def _escape(self) -> frozenset:
        c = self.next()
        if c in _ESCAPES:
            return _ESCAPES[c]
        return frozenset([ord(c)])  # \. \\ \[ \{ \" etc.

    def _char_class(self) -> frozenset:
        negate = False
        if self.peek() == "^":
            self.next()
            negate = True
        chars: set = set()
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unterminated character class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            self.next()
            if c == "\\":
                chars |= self._escape()
                continue
            lo = ord(c)
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.next()
                hi = ord(self.next())
                if hi < lo:
                    self.error(f"bad range {chr(lo)}-{chr(hi)}")
                chars |= set(range(lo, hi + 1))
            else:
                chars.add(lo)
        if negate:
            chars = set(range(_MAX_CHAR)) - chars
        if not chars:
            self.error("empty character class")
        return frozenset(chars)


def re_escape(text: str) -> str:
    """Escape regex metacharacters so `text` matches literally (the
    schema lowering quotes JSON keys and enum values through this)."""
    out = []
    for c in text:
        if c in "\\.[](){}|*+?^-":
            out.append("\\" + c)
        else:
            out.append(c)
    return "".join(out)


# ---------------------------------------------------------------------
# Thompson NFA + subset-construction DFA
# ---------------------------------------------------------------------
class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.chr: List[List[Tuple[frozenset, int]]] = []

    def state(self) -> int:
        self.eps.append([])
        self.chr.append([])
        return len(self.eps) - 1

    def build(self, node) -> Tuple[int, int]:
        """Thompson construction: returns (start, accept) of the
        fragment for `node`."""
        kind = node[0]
        if kind == "eps":
            s = self.state()
            return s, s
        if kind == "lit":
            s, a = self.state(), self.state()
            self.chr[s].append((node[1], a))
            return s, a
        if kind == "cat":
            s, a = self.build(node[1][0])
            for part in node[1][1:]:
                ps, pa = self.build(part)
                self.eps[a].append(ps)
                a = pa
            return s, a
        if kind == "alt":
            s, a = self.state(), self.state()
            for branch in node[1]:
                bs, ba = self.build(branch)
                self.eps[s].append(bs)
                self.eps[ba].append(a)
            return s, a
        if kind == "rep":
            _, sub, m, n = node
            s = self.state()
            cur = s
            for _i in range(m):
                ps, pa = self.build(sub)
                self.eps[cur].append(ps)
                cur = pa
            if n is None:  # sub{m,} = sub^m sub*
                ls, la = self.build(sub)
                loop = self.state()
                self.eps[cur].append(loop)
                self.eps[loop].append(ls)
                self.eps[la].append(loop)
                return s, loop
            a = self.state()
            self.eps[cur].append(a)
            for _i in range(n - m):  # (n-m) trailing optionals
                ps, pa = self.build(sub)
                self.eps[cur].append(ps)
                cur = pa
                self.eps[cur].append(a)
            return s, a
        raise AssertionError(f"unknown AST node {kind}")


_MAX_DFA_STATES = 4096


class CharDFA:
    """Deterministic char-level automaton, TRIMMED: every state can
    reach an accepting state (a transition into a dead-end simply does
    not exist), so "this token has a next state" IS "this token can
    still complete the grammar" — the property the mask table needs."""

    def __init__(self, trans: List[Dict[int, int]],
                 accepting: List[bool]):
        self.trans = trans
        self.accepting = accepting
        self.n_states = len(trans)

    def matches(self, text: str) -> bool:
        s = 0
        for ch in text:
            s = self.trans[s].get(ord(ch), -1)
            if s < 0:
                return False
        return self.accepting[s]


def compile_regex(pattern: str) -> CharDFA:
    """pattern -> trimmed DFA. Raises GrammarCompileError on malformed
    patterns, state blowup past a hard cap, or a grammar matching no
    string at all (the unsatisfiable case MUST refuse at compile time:
    admitting it would dead-end every sample at its first token)."""
    ast = _RegexParser(pattern).parse()
    nfa = _NFA()
    start, accept = nfa.build(ast)

    def closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for t in nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    start_set = closure(frozenset([start]))
    ids = {start_set: 0}
    order = [start_set]
    trans: List[Dict[int, int]] = [{}]
    work = [start_set]
    while work:
        cur = work.pop()
        ci = ids[cur]
        # chars with at least one outgoing edge from this state set
        moves: Dict[int, set] = {}
        for s in cur:
            for charset, dst in nfa.chr[s]:
                for ch in charset:
                    moves.setdefault(ch, set()).add(dst)
        for ch, dsts in moves.items():
            nxt = closure(frozenset(dsts))
            if nxt not in ids:
                if len(ids) >= _MAX_DFA_STATES:
                    raise GrammarCompileError(
                        f"grammar too large: DFA exceeds "
                        f"{_MAX_DFA_STATES} states")
                ids[nxt] = len(ids)
                order.append(nxt)
                trans.append({})
                work.append(nxt)
            trans[ci][ch] = ids[nxt]
    accepting = [accept in st for st in order]

    # trim: keep only states co-reachable from an accepting state
    n = len(order)
    rev: List[List[int]] = [[] for _ in range(n)]
    for s, edges in enumerate(trans):
        for dst in edges.values():
            rev[dst].append(s)
    live = set(i for i in range(n) if accepting[i])
    stack = list(live)
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise GrammarCompileError(
            f"grammar matches no string (unsatisfiable): {pattern!r}")
    remap = {}
    remap[0] = 0
    for s in range(n):
        if s in live and s not in remap:
            remap[s] = len(remap)
    new_trans: List[Dict[int, int]] = [{} for _ in range(len(remap))]
    new_accept = [False] * len(remap)
    for s, ns in remap.items():
        new_accept[ns] = accepting[s]
        for ch, dst in trans[s].items():
            if dst in remap:
                new_trans[ns][ch] = remap[dst]
    return CharDFA(new_trans, new_accept)


# ---------------------------------------------------------------------
# JSON-schema subset -> regex lowering
# ---------------------------------------------------------------------
# The dialect is the intersection of "what tool-call traffic needs"
# and "what lowers to a REGULAR language with no host work per token":
# objects with a fixed property order (every listed property emitted,
# in declaration order, no whitespace — canonical compact JSON),
# strings (enum, or bounded length over a JSON-safe class), integers/
# numbers with bounded digits, booleans, null, const/enum, bounded
# arrays. Unsupported constructs refuse LOUDLY at compile time.
_STR_CLASS = "[A-Za-z0-9_\\- .:/@]"
_DEFAULT_MAX_STRING = 16
_DEFAULT_MAX_DIGITS = 6


def _json_literal_regex(value) -> str:
    return re_escape(json.dumps(value, separators=(",", ":")))


def schema_to_regex(schema: dict) -> str:
    """Lower a JSON-schema subset to the regex dialect above. The
    result matches ONLY canonical compact serializations (no
    whitespace, properties in declaration order) — a deliberate
    restriction: the output must PARSE, it does not have to cover
    every equivalent serialization."""
    if not isinstance(schema, dict):
        raise GrammarCompileError(
            f"schema must be an object, got {type(schema).__name__}")
    if "const" in schema:
        return _json_literal_regex(schema["const"])
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, (list, tuple)) or not vals:
            raise GrammarCompileError("enum must be a non-empty array")
        return "(" + "|".join(_json_literal_regex(v) for v in vals) + ")"
    t = schema.get("type")
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t in ("integer", "number"):
        digits = int(schema.get("maxDigits", _DEFAULT_MAX_DIGITS))
        if digits < 1:
            raise GrammarCompileError("maxDigits must be >= 1")
        sign = "" if schema.get("minimum", -1) >= 0 else "-?"
        body = f"(0|{sign}[1-9][0-9]{{0,{digits - 1}}})"
        if t == "number":
            body += "(\\.[0-9]{1,%d})?" % digits
        return body
    if t == "string":
        lo = int(schema.get("minLength", 0))
        hi = int(schema.get("maxLength", _DEFAULT_MAX_STRING))
        if lo < 0 or hi < lo:
            raise GrammarCompileError(
                f"bad string bounds minLength={lo} maxLength={hi}")
        return f'"{_STR_CLASS}{{{lo},{hi}}}"'
    if t == "array":
        items = schema.get("items")
        if items is None:
            raise GrammarCompileError("array schema requires 'items'")
        inner = schema_to_regex(items)
        lo = int(schema.get("minItems", 0))
        hi = int(schema.get("maxItems", 4))
        if lo < 0 or hi < lo:
            raise GrammarCompileError(
                f"bad array bounds minItems={lo} maxItems={hi}")
        if hi == 0:
            return "\\[\\]"
        body = f"\\[{inner}(,{inner}){{{max(lo - 1, 0)},{hi - 1}}}\\]"
        if lo == 0:
            return f"(\\[\\]|{body})"
        return body
    if t == "object":
        props = schema.get("properties")
        if not isinstance(props, dict) or not props:
            raise GrammarCompileError(
                "object schema requires non-empty 'properties'")
        parts = []
        for key, sub in props.items():
            parts.append(f"{_json_literal_regex(key)}:"
                         f"{schema_to_regex(sub)}")
        return "\\{" + ",".join(parts) + "\\}"
    raise GrammarCompileError(
        f"unsupported schema construct: {schema!r} (supported: object/"
        f"array/string/integer/number/boolean/null/const/enum)")


# ---------------------------------------------------------------------
# token composition: char DFA -> token-level FSM tables
# ---------------------------------------------------------------------
def default_token_strings(vocab_size: int) -> List[str]:
    """Byte-level identity tokenizer: token id i IS the character
    chr(i). The harness-scale models (vocab 128) decode ASCII through
    this; a real tokenizer passes its own piece strings instead."""
    return [chr(i) for i in range(vocab_size)]


class TokenFSM:
    """Token-level grammar automaton: the admission-time artifact the
    engine drives. All tables are precomputed NumPy — the hot loop
    reads `mask_table[state]` (one row) and `next_table[state, token]`
    (one int), nothing else.

    mask_table [n_states, V] bool — True where emitting the token
        keeps the grammar completable (the DFA is trimmed, so "has a
        next state" == "can still reach accept"). The EOS column, when
        an eos id exists, is True exactly on accepting states.
    next_table [n_states, V] int32 — successor state, -1 illegal.
    accepting [n_states] bool — the emitted text so far is a complete
        match (EOS legal here; for eos-less models the engine finishes
        the request when the state is accepting AND terminal).
    max_path_len — longest possible number of non-EOS tokens a
        conforming completion can emit, or None for cyclic (unbounded)
        grammars. A bounded grammar with max_new_tokens >= max_path_len
        GUARANTEES the final text parses (the invariant checker's
        final-parse law keys on this).
    """

    def __init__(self, dfa: CharDFA, token_strings: Sequence[str],
                 eos_id: Optional[int] = None,
                 response_format: Optional[dict] = None):
        V = len(token_strings)
        self.vocab_size = V
        self.eos_id = (int(eos_id)
                       if eos_id is not None and 0 <= int(eos_id) < V
                       else None)
        self.dfa = dfa
        self.token_strings = list(token_strings)
        self.response_format = response_format
        n = dfa.n_states
        self.n_states = n
        next_table = np.full((n, V), -1, np.int32)
        for t, piece in enumerate(token_strings):
            if not piece:
                continue  # zero-progress token: emitting it forever
                # would never advance the grammar — illegal everywhere
            codes = [ord(c) for c in piece]
            for s in range(n):
                cur = s
                for code in codes:
                    cur = dfa.trans[cur].get(code, -1)
                    if cur < 0:
                        break
                if cur >= 0:
                    next_table[s, t] = cur
        self.accepting = np.asarray(dfa.accepting, dtype=np.bool_)
        mask_table = next_table >= 0
        if self.eos_id is not None:
            next_table[:, self.eos_id] = -1
            mask_table[:, self.eos_id] = self.accepting
        self.next_table = next_table
        self.mask_table = np.ascontiguousarray(mask_table)
        if not self.mask_table[0].any():
            raise GrammarCompileError(
                "grammar admits no legal first token under this "
                "tokenizer (every opening character is untokenizable)")
        self.max_path_len = self._longest_path()

    # ---- stepping (engine hot loop) ---------------------------------
    def allowed(self, state: int) -> np.ndarray:
        """[V] bool mask of legal next tokens from `state`."""
        return self.mask_table[state]

    def step(self, state: int, token: int) -> int:
        """Successor state after emitting `token` (-1 = grammar
        violation). EOS from an accepting state is legal and
        self-loops (the request is finishing — there is no 'after')."""
        if self.eos_id is not None and token == self.eos_id:
            return state if self.accepting[state] else -1
        if not (0 <= token < self.vocab_size):
            return -1
        return int(self.next_table[state, token])

    def is_accepting(self, state: int) -> bool:
        return bool(self.accepting[state])

    def is_terminal(self, state: int) -> bool:
        """No legal NON-EOS continuation exists: the request must stop
        here (successfully if accepting — post-trim, a terminal state
        is always accepting)."""
        row = self.mask_table[state]
        if self.eos_id is not None:
            legal = row.copy()
            legal[self.eos_id] = False
            return not legal.any()
        return not row.any()

    def decode(self, tokens: Sequence[int]) -> str:
        return "".join(self.token_strings[t] for t in tokens
                       if 0 <= t < self.vocab_size
                       and t != self.eos_id)

    # ---- boundedness -------------------------------------------------
    def _longest_path(self) -> Optional[int]:
        """Longest token path from the start state, or None when a
        reachable cycle makes the grammar unbounded. Iterative DFS
        with an explicit stack (a 4k-state DFA would blow the
        recursion limit)."""
        succ: List[List[int]] = []
        for s in range(self.n_states):
            row = self.next_table[s]
            succ.append(sorted(set(int(x) for x in row[row >= 0])))
        WHITE, GRAY, BLACK = 0, 1, 2
        color = [WHITE] * self.n_states
        depth = [0] * self.n_states
        stack: List[Tuple[int, int]] = [(0, 0)]
        while stack:
            s, idx = stack.pop()
            if idx == 0:
                if color[s] == BLACK:
                    continue
                color[s] = GRAY
            if idx < len(succ[s]):
                stack.append((s, idx + 1))
                t = succ[s][idx]
                if color[t] == GRAY:
                    return None  # reachable cycle
                if color[t] == WHITE:
                    stack.append((t, 0))
            else:
                color[s] = BLACK
                depth[s] = 1 + max((depth[t] for t in succ[s]),
                                   default=-1) \
                    if succ[s] else 0
        return depth[0]

    # ---- validity (invariant checker) --------------------------------
    def replay(self, tokens: Sequence[int]) -> Tuple[bool, int]:
        """Replay generated tokens from the start state. Returns
        (all_legal, final_state): every token must be legal from its
        state, and EOS — if emitted — must be last. final_state is -1
        on the first violation."""
        s = 0
        toks = list(tokens)
        for i, t in enumerate(toks):
            if self.eos_id is not None and t == self.eos_id:
                if not self.accepting[s] or i != len(toks) - 1:
                    return False, -1
                return True, s
            nxt = self.step(s, int(t))
            if nxt < 0:
                return False, -1
            s = nxt
        return True, s

    def final_text_valid(self, tokens: Sequence[int]) -> bool:
        """The completed request's text parses against the source
        grammar: DFA acceptance, plus an actual json.loads round-trip
        when the grammar came from a JSON schema (belt and braces —
        the lowering promises canonical JSON, this checks it kept the
        promise)."""
        text = self.decode(tokens)
        if not self.dfa.matches(text):
            return False
        rf = self.response_format or {}
        if rf.get("type") == "json_schema":
            try:
                json.loads(text)
            except ValueError:
                return False
        return True


# ---------------------------------------------------------------------
# front door: response_format validation + compilation
# ---------------------------------------------------------------------
def validate_response_format(rf) -> Optional[str]:
    """Cheap structural validation for the HTTP boundary (no grammar
    compile): returns an error string (-> typed 400) or None. The
    full compile happens at engine submit and raises
    GrammarCompileError for semantically-bad grammars."""
    if not isinstance(rf, dict):
        return "response_format must be an object"
    t = rf.get("type")
    if t == "regex":
        if not isinstance(rf.get("pattern"), str) or not rf["pattern"]:
            return ("response_format type 'regex' requires a non-empty "
                    "string 'pattern'")
        return None
    if t == "json_schema":
        if not isinstance(rf.get("schema"), dict):
            return ("response_format type 'json_schema' requires an "
                    "object 'schema'")
        return None
    return ("response_format.type must be 'regex' or 'json_schema', "
            f"got {t!r}")


def compile_response_format(rf: dict, vocab_size: int,
                            token_strings: Optional[Sequence[str]] = None,
                            eos_id: Optional[int] = None) -> TokenFSM:
    """response_format -> TokenFSM, the engine's admission-time entry
    point. Raises GrammarCompileError (-> 400) for anything that
    cannot become a per-token table lookup."""
    err = validate_response_format(rf)
    if err is not None:
        raise GrammarCompileError(err)
    if rf["type"] == "regex":
        pattern = rf["pattern"]
    else:
        pattern = schema_to_regex(rf["schema"])
    dfa = compile_regex(pattern)
    if token_strings is None:
        token_strings = default_token_strings(vocab_size)
    return TokenFSM(dfa, token_strings, eos_id=eos_id,
                    response_format=rf)
