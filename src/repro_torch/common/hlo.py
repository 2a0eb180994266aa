"""Loop-aware cost + collective analysis of compiled (post-SPMD) HLO text.

Why this exists: ``compiled.cost_analysis()`` counts ``while`` bodies ONCE —
with scan-over-layers models (the only way 100-layer archs compile fast), XLA
under-reports FLOPs/bytes by ~num_layers x, and a text grep for collectives
under-counts the same way. This module parses the HLO module into
computations, walks the call graph, multiplies ``while`` bodies by their trip
count (recovered from the loop-condition constant), applies XLA's fusion
memory model (a fusion reads its operands and writes its outputs once), and
accumulates:

  * flops            - dot ops from shapes + contraction dims; ~1 flop/elem
                       for elementwise; input-size for reduces
  * hbm_bytes        - sum of operand+output bytes of every non-fused op
  * collectives      - per-kind counts / operand bytes / modeled ICI traffic

All quantities are per-device (the HLO is already SPMD-partitioned).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "s32": 4, "u32": 4,
    "s64": 8, "u64": 8, "f16": 2, "bf16": 2, "f32": 4, "f64": 8,
    "c64": 8, "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "s4": 1, "u4": 1,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COMP_HDR_RE = re.compile(r"^(ENTRY\s+)?%?([\w.\-]+)\s*\(.*\)\s*->\s*.*\{\s*$")
_OP_RE = re.compile(r"^\s*(ROOT\s+)?%([\w.\-]+)\s*=\s*(.*)$")
_OPCODE_RE = re.compile(r"^\s*([a-z][\w\-]*)\(")
_ATTR_COMP_RE = {
    "body": re.compile(r"body=%([\w.\-]+)"),
    "condition": re.compile(r"condition=%([\w.\-]+)"),
    "calls": re.compile(r"calls=%([\w.\-]+)"),
    "branches": re.compile(r"branch_computations=\{([^}]*)\}"),
}

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

_ELEMWISE = {
    "add", "subtract", "multiply", "divide", "maximum", "minimum", "abs",
    "negate", "exponential", "exponential-minus-one", "log", "log-plus-one",
    "tanh", "rsqrt", "sqrt", "power", "sign", "floor", "ceil", "cosine",
    "sine", "compare", "select", "and", "or", "not", "xor", "clamp",
    "remainder", "atan2", "is-finite", "round-nearest-afz",
    "round-nearest-even", "shift-left", "shift-right-logical",
    "shift-right-arithmetic", "popcnt", "clz", "erf", "logistic", "cbrt",
}
_ZERO_BYTES = {"parameter", "constant", "tuple", "get-tuple-element",
               "bitcast", "after-all", "iota", "partition-id", "replica-id"}
_ZERO_FLOPS = _ZERO_BYTES | {
    "copy", "reshape", "broadcast", "transpose", "slice", "dynamic-slice",
    "dynamic-update-slice", "concatenate", "pad", "reverse", "gather",
    "scatter", "convert", "rng", "rng-bit-generator", "custom-call",
    "infeed", "outfeed", "send", "recv", "sort", "while", "conditional",
    "fusion", "call", "map", "reduce", "reduce-window", "convolution",
    "optimization-barrier", "domain", "copy-start", "copy-done",
}


def _parse_dims(dims: str) -> Tuple[int, ...]:
    if not dims:
        return ()
    return tuple(int(d) for d in dims.split(","))


def _shapes_in(text: str) -> List[Tuple[str, Tuple[int, ...]]]:
    return [(dt, _parse_dims(dims)) for dt, dims in _SHAPE_RE.findall(text)
            if dt in _DTYPE_BYTES]


def _bytes_of_shapes(shapes) -> int:
    total = 0
    for dt, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dt]
    return total


def _elems_of_shapes(shapes) -> int:
    total = 0
    for _, dims in shapes:
        n = 1
        for d in dims:
            n *= d
        total += n
    return total


@dataclasses.dataclass
class HloOp:
    name: str
    opcode: str
    head: str            # output shape portion
    rhs: str             # full right-hand side
    operands: List[str]
    is_root: bool = False
    scope: str = ""      # jax op_name metadata (named_scope path)


def _match_paren(s: str, start: int) -> int:
    depth = 0
    for i in range(start, len(s)):
        if s[i] == "(":
            depth += 1
        elif s[i] == ")":
            depth -= 1
            if depth == 0:
                return i
    return len(s) - 1


def _split_rhs(rhs: str):
    """'TYPE opcode(operands), attrs' -> (type_str, opcode, operand_region).

    TYPE may be a parenthesized tuple type (while/scan outputs)."""
    rhs = rhs.strip()
    if rhs.startswith("("):
        close = _match_paren(rhs, 0)
        head = rhs[:close + 1]
        rest = rhs[close + 1:].strip()
    else:
        j = rhs.find("(")
        if j < 0:
            return rhs, None, ""
        pre = rhs[:j].strip()
        parts = pre.rsplit(None, 1)
        if len(parts) == 2:
            head, opcode = parts
        else:
            head, opcode = "", parts[0] if parts else ""
        close = _match_paren(rhs, j)
        return head, opcode, rhs[j + 1:close]
    # tuple-typed: rest = 'opcode(operands), attrs'
    j = rest.find("(")
    if j < 0:
        return head, None, ""
    opcode = rest[:j].strip().split()[-1] if rest[:j].strip() else ""
    close = _match_paren(rest, j)
    return head, opcode, rest[j + 1:close]


def parse_module(hlo_text: str):
    """-> (computations: {name: [HloOp]}, entry_name, symbols: {comp: {op: shapes}})."""
    comps: Dict[str, List[HloOp]] = {}
    entry = None
    cur: Optional[str] = None
    for line in hlo_text.splitlines():
        hdr = _COMP_HDR_RE.match(line.strip())
        if hdr and "=" not in line.split("(")[0]:
            cur = hdr.group(2)
            comps[cur] = []
            if hdr.group(1):
                entry = cur
            continue
        if line.strip() == "}":
            cur = None
            continue
        if cur is None:
            continue
        m = _OP_RE.match(line)
        if not m:
            continue
        is_root, name, rhs = bool(m.group(1)), m.group(2), m.group(3)
        head, opcode, op_region = _split_rhs(rhs)
        if opcode is None:
            continue
        operands = re.findall(r"%([\w.\-]+)", op_region)
        sm = re.search(r'op_name="([^"]*)"', rhs)
        comps[cur].append(HloOp(name, opcode, head, rhs, operands, is_root,
                                sm.group(1) if sm else ""))
    symbols: Dict[str, Dict[str, list]] = {}
    for cname, ops in comps.items():
        tbl = {}
        for op in ops:
            tbl[op.name] = _shapes_in(op.head)
        symbols[cname] = tbl
    return comps, entry, symbols


def _trip_count(cond_ops: List[HloOp]) -> int:
    best = 1
    for op in cond_ops:
        if op.opcode == "constant":
            m = re.search(r"constant\((\d+)\)", op.rhs)
            if m and re.match(r"^[su]\d+\[\]", op.head.strip()):
                best = max(best, int(m.group(1)))
    return best


_CONTRACT_RE = re.compile(r"lhs_contracting_dims=\{([\d,]*)\}")


def _dot_flops(op: HloOp, tbl) -> float:
    out_elems = _elems_of_shapes(_shapes_in(op.head))
    m = _CONTRACT_RE.search(op.rhs)
    k = 1
    if m and op.operands:
        lhs_shapes = tbl.get(op.operands[0], [])
        if lhs_shapes:
            dims = lhs_shapes[0][1]
            for ci in _parse_dims(m.group(1)):
                if ci < len(dims):
                    k *= dims[ci]
    return 2.0 * out_elems * k


def _op_flops(op: HloOp, tbl) -> float:
    if op.opcode == "dot":
        return _dot_flops(op, tbl)
    if op.opcode in ("reduce", "reduce-window"):
        in_elems = sum(_elems_of_shapes(tbl.get(o, [])) for o in op.operands)
        return float(in_elems)
    if op.opcode in _ELEMWISE:
        return float(_elems_of_shapes(_shapes_in(op.head)))
    if op.opcode == "convolution":
        # not used by this framework; approximate as output elems
        return float(_elems_of_shapes(_shapes_in(op.head)))
    return 0.0


def _op_bytes(op: HloOp, tbl) -> int:
    if op.opcode in _ZERO_BYTES:
        return 0
    out_b = _bytes_of_shapes(_shapes_in(op.head))
    # Slicing/indexing ops only touch the sliced region, not the whole
    # operand (critical: scan-over-layers dynamic-slices a [L, ...] stacked
    # weight per iteration — counting the full stack would over-report HBM
    # traffic by ~L x). Model: read touched region + write output; d-u-s
    # aliases its buffer in place (read update, write update-sized region).
    if op.opcode in ("slice", "dynamic-slice", "gather"):
        return 2 * out_b
    if op.opcode == "dynamic-update-slice":
        upd = (_bytes_of_shapes(tbl.get(op.operands[1], []))
               if len(op.operands) > 1 else out_b)
        return 2 * upd
    if op.opcode == "scatter":
        upd = (_bytes_of_shapes(tbl.get(op.operands[2], []))
               if len(op.operands) > 2 else out_b)
        return 3 * upd  # read region + read updates + write
    in_b = sum(_bytes_of_shapes(tbl.get(o, [])) for o in op.operands)
    return out_b + in_b


# per-chip ICI traffic factors (ring algorithms)
def _traffic_factor(kind: str, group_size: int) -> float:
    g = max(group_size, 1)
    if kind == "all-gather":
        return float(g - 1)
    if kind == "all-reduce":
        return 2.0 * (g - 1) / g
    if kind in ("reduce-scatter", "all-to-all"):
        return float(g - 1) / g
    if kind == "collective-permute":
        return 1.0
    return 1.0


def _group_size(rhs: str, num_devices: int) -> int:
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=", rhs)
    if m:
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{([\d,]+)\}", rhs)
    if m:
        return len(m.group(1).split(","))
    return num_devices


@dataclasses.dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    collective_operand_bytes: float = 0.0
    collective_traffic_bytes: float = 0.0
    collective_count: float = 0.0
    by_kind: Dict[str, dict] = dataclasses.field(default_factory=dict)
    max_trip_seen: int = 1


class HloAnalysis:
    def __init__(self, hlo_text: str, num_devices: int,
                 fused_scopes: Tuple[str, ...] = ()):
        """fused_scopes: named_scope substrings whose ops are VMEM-resident
        in a shipped fused kernel — their HBM bytes are discounted (flops
        still counted). Used by the perf variants to account for the Pallas
        flash-attention kernel that Mosaic cannot lower on this CPU-only
        runtime (the kernel itself is validated in interpret mode)."""
        self.comps, self.entry, self.symbols = parse_module(hlo_text)
        self.n = num_devices
        self.fused_scopes = tuple(fused_scopes)
        self.totals = Totals()
        if self.entry:
            self._walk(self.entry, 1.0, 0)

    def _in_fused_scope(self, op: HloOp) -> bool:
        return any(s in op.scope for s in self.fused_scopes)

    def _comp_flops_only(self, cname: str) -> float:
        tbl = self.symbols.get(cname, {})
        return sum(_op_flops(op, tbl) for op in self.comps.get(cname, []))

    def _comp_in_scope(self, cname: str) -> bool:
        """A fused computation is scope-discounted if most of its ops carry
        a fused scope (fusions mix boundary + internal ops)."""
        if not self.fused_scopes:
            return False
        ops = [o for o in self.comps.get(cname, [])
               if o.opcode not in ("parameter", "constant")]
        if not ops:
            return False
        hits = sum(1 for o in ops if self._in_fused_scope(o))
        return hits * 2 > len(ops)

    def _fusion_bytes(self, op: HloOp, tbl, called: Optional[str]) -> int:
        """Fusion memory model with slice/in-place-update awareness.

        A fusion reads its operands + writes its output — except operands
        that are (a) only dynamic-sliced inside (touch slice-sized region),
        or (b) the aliased buffer of an in-place dynamic-update-slice
        (touch update-sized region). Without this, scan-over-layers (which
        slices [L, ...] weight stacks and update-slices [L, ...] output
        stacks per iteration) over-reports HBM traffic by ~L x.
        """
        out_b = _bytes_of_shapes(_shapes_in(op.head))
        if called is None or called not in self.comps:
            in_b = sum(_bytes_of_shapes(tbl.get(o, []))
                       for o in op.operands)
            return out_b + in_b
        comp = self.comps[called]
        ctbl = self.symbols[called]
        # parameter index -> fusion operand name
        param_of = {}
        for cop in comp:
            if cop.opcode == "parameter":
                m = re.search(r"parameter\((\d+)\)", cop.rhs)
                if m and int(m.group(1)) < len(op.operands):
                    param_of[cop.name] = op.operands[int(m.group(1))]
        sliced = {}      # operand name -> touched bytes
        aliased = {}     # operand name -> update bytes (in-place dus)
        consumers: Dict[str, int] = {}
        for cop in comp:
            for o in cop.operands:
                consumers[o] = consumers.get(o, 0) + 1
        for cop in comp:
            if cop.opcode in ("dynamic-slice", "gather") and cop.operands:
                src = cop.operands[0]
                if src in param_of and consumers.get(src, 0) == 1:
                    touched = _bytes_of_shapes(_shapes_in(cop.head))
                    onm = param_of[src]
                    sliced[onm] = sliced.get(onm, 0) + touched
            if cop.opcode == "dynamic-update-slice" and len(cop.operands) > 1:
                buf = cop.operands[0]
                upd_b = _bytes_of_shapes(ctbl.get(cop.operands[1], []))
                if buf in param_of and consumers.get(buf, 0) == 1:
                    aliased[param_of[buf]] = \
                        aliased.get(param_of[buf], 0) + upd_b
                    if cop.is_root:
                        # output aliases the input buffer; write = update
                        out_b = upd_b
        total = out_b
        seen_special = set()
        for onm in op.operands:
            if onm in aliased and onm not in seen_special:
                total += aliased[onm]
                seen_special.add(onm)
            elif onm in sliced and onm not in seen_special:
                total += sliced[onm]
                seen_special.add(onm)
            else:
                total += _bytes_of_shapes(tbl.get(onm, []))
        return total

    def _collective(self, op: HloOp, tbl, mult: float):
        kind = next(k for k in COLLECTIVE_KINDS if op.opcode.startswith(k))
        if op.opcode.endswith("-done"):
            return
        operand_bytes = sum(_bytes_of_shapes(tbl.get(o, []))
                            for o in op.operands)
        if operand_bytes == 0:
            operand_bytes = _bytes_of_shapes(_shapes_in(op.head))
        gs = _group_size(op.rhs, self.n)
        traffic = operand_bytes * _traffic_factor(kind, gs)
        t = self.totals
        t.collective_operand_bytes += operand_bytes * mult
        t.collective_traffic_bytes += traffic * mult
        t.collective_count += mult
        d = t.by_kind.setdefault(kind, {"count": 0.0, "operand_bytes": 0.0,
                                        "traffic_bytes": 0.0})
        d["count"] += mult
        d["operand_bytes"] += operand_bytes * mult
        d["traffic_bytes"] += traffic * mult

    def _walk(self, cname: str, mult: float, depth: int):
        if depth > 12 or cname not in self.comps:
            return
        tbl = self.symbols[cname]
        t = self.totals
        for op in self.comps[cname]:
            if any(op.opcode.startswith(k) for k in COLLECTIVE_KINDS):
                self._collective(op, tbl, mult)
                continue
            if op.opcode == "while":
                cond = _ATTR_COMP_RE["condition"].search(op.rhs)
                body = _ATTR_COMP_RE["body"].search(op.rhs)
                trips = 1
                if cond and cond.group(1) in self.comps:
                    trips = _trip_count(self.comps[cond.group(1)])
                t.max_trip_seen = max(t.max_trip_seen, trips)
                if body:
                    self._walk(body.group(1), mult * trips, depth + 1)
                if cond:
                    self._walk(cond.group(1), mult * trips, depth + 1)
                continue
            if op.opcode == "conditional":
                m = _ATTR_COMP_RE["branches"].search(op.rhs)
                if m:
                    branches = re.findall(r"%([\w.\-]+)", m.group(1))
                    # average over branches (causal block-skip: ~half run)
                    for b in branches:
                        self._walk(b, mult / max(len(branches), 1), depth + 1)
                continue
            if op.opcode in ("fusion", "call", "map"):
                m = _ATTR_COMP_RE["calls"].search(op.rhs) or \
                    re.search(r"to_apply=%([\w.\-]+)", op.rhs)
                called = m.group(1) if m else None
                if called:
                    t.flops += self._comp_flops_only(called) * mult
                if not (self._in_fused_scope(op) or
                        (called and self._comp_in_scope(called))):
                    t.bytes += self._fusion_bytes(op, tbl, called) * mult
                continue
            t.flops += _op_flops(op, tbl) * mult
            if not self._in_fused_scope(op):
                t.bytes += _op_bytes(op, tbl) * mult

    def summary(self) -> dict:
        t = self.totals
        return {
            "flops_per_chip": t.flops,
            "hbm_bytes_per_chip": t.bytes,
            "num_collectives": t.collective_count,
            "total_operand_bytes": t.collective_operand_bytes,
            "total_traffic_bytes": t.collective_traffic_bytes,
            "by_kind": t.by_kind,
            "max_loop_trip": t.max_trip_seen,
        }


def analyze(hlo_text: str, num_devices: int,
            fused_scopes: Tuple[str, ...] = ()) -> dict:
    return HloAnalysis(hlo_text, num_devices, fused_scopes).summary()


def collective_summary(hlo_text: str, num_devices: int) -> dict:
    """Loop-aware collective accounting (back-compat name)."""
    s = analyze(hlo_text, num_devices)
    return {k: s[k] for k in ("num_collectives", "total_operand_bytes",
                              "total_traffic_bytes", "by_kind")}
