"""Minimal reader for R workspace files (.RData / .Rdata, RDX2 XDR).

Counterpart of ``machisplin_tpu/io/rdata.py``.  The reference bundles its
fixtures as R serializations (data/sampling.RData and data/example.dat.Rdata,
loaded in R via ``data(sampling)``, R/data.R:1-38).  This module decodes the
subset of R's version-2 XDR serialization those files (and typical
``save(data.frame)`` files) use: pairlists, symbols, attribute lists,
character/integer/real/logical vectors, generic vectors (R lists) and
back-references (R Internals, "Serialization Formats").

``read_rdata(path)`` -> dict of top-level name -> Python object, where
data.frames decode to NumPy structured arrays (the shape ``load_sampling``
returns for the CSV).
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

__all__ = ["read_rdata"]

# SEXP type codes (R Internals, Rinternals.h)
_NILSXP = 0
_SYMSXP = 1
_LISTSXP = 2
_CHARSXP = 9
_LGLSXP = 10
_INTSXP = 13
_REALSXP = 14
_CPLXSXP = 15
_STRSXP = 16
_VECSXP = 19
_RAWSXP = 24
# pseudo-codes used by the serializer
_REFSXP = 255
_NILVALUE_SXP = 254
_GLOBALENV_SXP = 253
_MISSINGARG_SXP = 251
_BASENAMESPACE_SXP = 252
_NAMESPACESXP = 249
_ALTREP_SXP = 238

_NA_INTEGER = -2147483648


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.refs: list = []

    def _take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise ValueError("truncated RData stream")
        self.pos += n
        return b

    def u32(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def f64s(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(8 * n), dtype=">f8").astype(np.float64)

    def i32s(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(4 * n), dtype=">i4").astype(np.int64)

    # ---- grammar ---------------------------------------------------------

    def read_item(self):
        flags = self.u32()
        sxp = flags & 0xFF
        has_attr = bool(flags & 0x200)
        has_tag = bool(flags & 0x400)

        if sxp == _REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.u32()
            return self.refs[idx - 1]
        if sxp in (_NILVALUE_SXP, _NILSXP):
            return None
        if sxp in (_GLOBALENV_SXP, _BASENAMESPACE_SXP, _MISSINGARG_SXP):
            return None
        if sxp == _SYMSXP:
            name = self.read_item()  # a CHARSXP
            self.refs.append(name)
            return name
        if sxp == _CHARSXP:
            n = self.i32()
            return None if n == -1 else self._take(n).decode("utf-8", "replace")
        if sxp == _LISTSXP:
            # dotted-pair list: [attrib][tag] CAR CDR — flatten to a dict-ish
            attrib = self.read_item() if has_attr else None
            tag = self.read_item() if has_tag else None
            car = self.read_item()
            cdr = self.read_item()
            out = [(tag, car)]
            if isinstance(cdr, list):
                out.extend(cdr)
            elif cdr is not None:
                out.append((None, cdr))
            del attrib
            return out
        if sxp == _STRSXP:
            n = self.i32()
            vals = [self.read_item() for _ in range(n)]
            return self._with_attr(np.asarray(vals, object), has_attr)
        if sxp == _VECSXP:
            n = self.i32()
            vals = [self.read_item() for _ in range(n)]
            return self._with_attr(vals, has_attr)
        if sxp == _REALSXP:
            n = self.i32()
            return self._with_attr(self.f64s(n), has_attr)
        if sxp == _INTSXP:
            n = self.i32()
            v = self.i32s(n)
            return self._with_attr(v, has_attr)
        if sxp == _LGLSXP:
            n = self.i32()
            v = self.i32s(n)
            out = np.where(v == _NA_INTEGER, -1, v).astype(np.int64)
            return self._with_attr(out, has_attr)
        if sxp == _RAWSXP:
            n = self.i32()
            return self._with_attr(np.frombuffer(self._take(n), np.uint8), has_attr)
        if sxp == _CPLXSXP:
            n = self.i32()
            re = self.f64s(2 * n)
            return self._with_attr(re[0::2] + 1j * re[1::2], has_attr)
        raise NotImplementedError(f"RData SEXP type {sxp} not supported")

    def _with_attr(self, value, has_attr: bool):
        if not has_attr:
            return value
        attrs = self.read_item() or []
        adict = {t: v for t, v in attrs if t is not None}
        return _decode_with_attrs(value, adict)


def _decode_with_attrs(value, attrs: dict):
    """Turn (vector, attributes) into the natural Python object: factors to
    their labels, data.frames to structured arrays, named lists to dicts."""
    cls = attrs.get("class")
    cls = list(cls) if cls is not None else []
    if "factor" in cls:
        levels = attrs.get("levels")
        idx = np.asarray(value, np.int64)
        out = np.asarray(
            [None if i == _NA_INTEGER or i < 1 else levels[i - 1] for i in idx],
            object,
        )
        return out
    if "data.frame" in cls and isinstance(value, list):
        names = [str(n) for n in attrs.get("names", [])]
        cols = []
        for c in value:
            a = np.asarray(c)
            if a.dtype == object:
                a = a.astype("U64")
            cols.append(a)
        return np.rec.fromarrays(cols, names=",".join(names))
    names = attrs.get("names")
    if names is not None and isinstance(value, list):
        return {str(n): v for n, v in zip(names, value)}
    return value


def read_rdata(path: str) -> dict:
    """Decode a .RData/.Rdata workspace: {object name: decoded object}."""
    raw = open(path, "rb").read()
    if raw[:2] == b"\x1f\x8b":
        raw = gzip.decompress(raw)
    if not raw.startswith(b"RDX2\n"):
        raise ValueError("not a version-2 RData file (RDX2 magic missing)")
    r = _Reader(raw[5:])
    fmt = r._take(2)
    if fmt != b"X\n":
        raise NotImplementedError(f"only XDR-format RData supported, got {fmt!r}")
    r.u32()  # serialization version
    r.u32()  # writer R version
    r.u32()  # minimum reader R version
    top = r.read_item()
    out = {}
    for tag, val in top or []:
        if tag is not None:
            out[str(tag)] = val
    return out
