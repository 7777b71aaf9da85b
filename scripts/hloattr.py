"""Shared HLO attribution: map executed instruction names to pipeline
stages/source lines.

Optimized-HLO instructions often carry no metadata themselves (fusions);
their fused computations do. This module parses a compiled module's text
once and exposes ``build_attr(text)`` returning
``{instr_name: (scope, src)}`` for every top-level entry instruction —
used by tracebench.py (profiler trace attribution, where trace event
names equal HLO instruction names).
"""

import collections
import re

_SKIP = ("parameter", "constant", "tuple", "get-tuple-element", "bitcast")

_DT_BYTES = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2,
             "s16": 2, "u16": 2, "pred": 1, "s8": 1, "u8": 1,
             "f64": 8, "s64": 8, "u64": 8}


def shape_bytes(shape_str):
    total = 0
    for m in re.finditer(r"(\w+)\[([\d,]*)\]", shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DT_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DT_BYTES[dt]
    return total


def _comp_scopes(text):
    comp_scope, comp_src = {}, {}
    for m in re.finditer(r"\n%?([\w.\-]+) [^\n]*\{(.*?)\n\}", text, re.S):
        cname, cbody = m.groups()
        sc = collections.Counter(re.findall(r'op_name="([^"]*)"', cbody))
        if sc:
            comp_scope[cname] = sc.most_common(1)[0][0]
        srcs = collections.Counter(
            f.rsplit("/", 1)[-1] + ":" + ln for f, ln in re.findall(
                r'source_file="([^"]*vulkansift_tpu[^"]*)"'
                r'.*?source_line=(\d+)', cbody))
        if srcs:
            comp_src[cname] = srcs.most_common(1)[0][0]
    return comp_scope, comp_src


def entry_instructions(text):
    """Yield (name, opkind, shape_str, line) for executed entry ops."""
    entry = re.search(r"ENTRY [^\{]*\{(.*?)\n\}", text, re.S)
    if not entry:
        return
    for line in entry.group(1).splitlines():
        line = line.strip()
        m = re.match(r"(?:ROOT )?%?([\w.\-]+) = ([^=]+?) ([\w\-]+)\(", line)
        if not m:
            continue
        name, shape_str, opkind = m.groups()
        if opkind in _SKIP:
            continue
        yield name, opkind, shape_str, line


def build_attr(text):
    """{instr_name: (scope, src)} for the entry computation."""
    comp_scope, comp_src = _comp_scopes(text)
    attr = {}
    for name, opkind, shape_str, line in entry_instructions(text):
        mm = re.search(r'op_name="([^"]*)"', line)
        scope = mm.group(1) if mm else ""
        src = None
        sm = re.search(r'source_file="([^"]*)".*?source_line=(\d+)', line)
        if sm and "vulkansift_tpu" in sm.group(1):
            src = sm.group(1).rsplit("/", 1)[-1] + ":" + sm.group(2)
        if not scope or not src:
            cm = re.search(r"(?:calls|fusion)=%?([\w.\-]+)", line)
            if cm:
                scope = scope or comp_scope.get(cm.group(1), "")
                src = src or comp_src.get(cm.group(1))
        attr[name] = (scope or "?", src or "?")
    return attr


def stage_of(scope):
    parts = [p for p in scope.split("/") if p and "jit(" not in p]
    return parts[0] if parts else "?"
