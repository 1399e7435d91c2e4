"""Dependency-free NetCDF-3 (classic / 64-bit-offset) reader and writer.

A copy of ``ocean_bgc_tpu/io/netcdf3.py`` (pure NumPy; the port imports
nothing of the JAX package): the same dataset gives the same bytes
(tests/test_torch_driver.py holds the two writers equal).

The reference library does no file I/O — its host (MPAS-Ocean/POP) reads
forcing and writes restarts/history as NetCDF (SURVEY.md §0).  A standalone
framework needs that capability, and this image has no netCDF library, so
this module implements the classic file format directly on NumPy: CDF-1
and CDF-2 magic, dimensions (including one UNLIMITED record dimension),
attributes, and all six external types.  The format spec is public
(NASA/Unidata "NetCDF Classic Format Specification"); files written here
open in any netCDF tool, and files produced by MPAS/POP/xarray (classic
format) load here.

Not supported (by design, rarely needed for forcing/restart exchange):
NetCDF-4/HDF5 containers and CDF-5.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

_MAGIC1 = b"CDF\x01"
_MAGIC2 = b"CDF\x02"

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C
_ABSENT = b"\x00" * 8

# nc_type -> (numpy dtype (big-endian), external size)
_TYPEMAP = {
    1: (np.dtype(">i1"), 1),   # NC_BYTE
    2: (np.dtype("S1"), 1),    # NC_CHAR
    3: (np.dtype(">i2"), 2),   # NC_SHORT
    4: (np.dtype(">i4"), 4),   # NC_INT
    5: (np.dtype(">f4"), 4),   # NC_FLOAT
    6: (np.dtype(">f8"), 8),   # NC_DOUBLE
}
_INV_TYPEMAP = {
    np.dtype("i1"): 1, np.dtype("S1"): 2, np.dtype("i2"): 3,
    np.dtype("i4"): 4, np.dtype("f4"): 5, np.dtype("f8"): 6,
}


def _round4(n: int) -> int:
    return (n + 3) & ~3


@dataclass
class Variable:
    """One netCDF variable: named dims, attributes, and its data array.
    ``data``'s shape must match the dimension lengths (record variables
    carry the record count as the leading axis)."""

    dims: Tuple[str, ...]
    data: np.ndarray
    attrs: Dict[str, object] = field(default_factory=dict)


@dataclass
class Dataset:
    """An in-memory netCDF-3 dataset."""

    dims: Dict[str, int] = field(default_factory=dict)   # name -> length
    variables: Dict[str, Variable] = field(default_factory=dict)
    attrs: Dict[str, object] = field(default_factory=dict)
    record_dim: Optional[str] = None                     # UNLIMITED dim


# --------------------------------------------------------------------------
# reading
# --------------------------------------------------------------------------

class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def bytes(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise ValueError("truncated netCDF file")
        self.pos += n
        return out

    def i4(self) -> int:
        return struct.unpack(">i", self.bytes(4))[0]

    def u4(self) -> int:
        return struct.unpack(">I", self.bytes(4))[0]

    def name(self) -> str:
        n = self.i4()
        s = self.bytes(_round4(n))[:n]
        return s.decode("utf-8")

    def values(self):
        nc_type = self.i4()
        n = self.i4()
        dt, size = _TYPEMAP[nc_type]
        raw = self.bytes(_round4(n * size))[:n * size]
        arr = np.frombuffer(raw, dtype=dt, count=n)
        if nc_type == 2:
            return arr.tobytes().decode("utf-8", errors="replace")
        return arr if n > 1 else arr[0]

    def attr_list(self) -> Dict[str, object]:
        tag = self.u4()
        n = self.i4()
        if tag == 0 and n == 0:
            return {}
        if tag != _NC_ATTRIBUTE:
            raise ValueError(f"bad attribute-list tag {tag:#x}")
        return {self.name(): self.values() for _ in range(n)}


def read(path: str) -> Dataset:
    """Parse a classic-format netCDF file into a :class:`Dataset`.
    All variable data is materialized (native byte order)."""
    with open(path, "rb") as f:
        buf = f.read()
    magic = buf[:4]
    if magic == _MAGIC1:
        offsize = 4
    elif magic == _MAGIC2:
        offsize = 8
    else:
        raise ValueError(
            f"not a classic netCDF file (magic {magic!r}); "
            "NetCDF-4/HDF5 is not supported by this reader")
    r = _Reader(buf)
    r.pos = 4
    numrecs = r.u4()

    ds = Dataset()
    # dim_list
    tag = r.u4()
    ndims = r.i4()
    dim_names: List[str] = []
    dim_sizes: List[int] = []
    if tag == _NC_DIMENSION:
        for _ in range(ndims):
            nm = r.name()
            ln = r.i4()
            dim_names.append(nm)
            dim_sizes.append(ln)
            if ln == 0:
                ds.record_dim = nm
    elif not (tag == 0 and ndims == 0):
        raise ValueError(f"bad dim-list tag {tag:#x}")

    ds.attrs = r.attr_list()

    # var_list
    tag = r.u4()
    nvars = r.i4()
    if tag not in (_NC_VARIABLE, 0):
        raise ValueError(f"bad var-list tag {tag:#x}")
    headers = []
    for _ in range(nvars if tag == _NC_VARIABLE else 0):
        nm = r.name()
        nd = r.i4()
        dimids = [r.i4() for _ in range(nd)]
        attrs = r.attr_list()
        nc_type = r.i4()
        _vsize = r.u4()
        begin = (r.u4() if offsize == 4
                 else struct.unpack(">Q", r.bytes(8))[0])
        headers.append((nm, dimids, attrs, nc_type, begin))

    rec_vars = [h for h in headers
                if h[1] and dim_sizes[h[1][0]] == 0]
    # record stride = sum of padded per-record sizes (special case: a
    # single record variable is NOT padded, per spec)
    strides = {}
    for nm, dimids, _a, nc_type, _b in rec_vars:
        dt, size = _TYPEMAP[nc_type]
        per_rec = size
        for d in dimids[1:]:
            per_rec *= dim_sizes[d]
        strides[nm] = per_rec
    recsize = (sum(_round4(s) for s in strides.values())
               if len(rec_vars) != 1 else
               next(iter(strides.values()), 0))

    for nm, dimids, attrs, nc_type, begin in headers:
        dt, size = _TYPEMAP[nc_type]
        dims = tuple(dim_names[d] for d in dimids)
        is_rec = bool(dimids) and dim_sizes[dimids[0]] == 0
        shape = [dim_sizes[d] for d in dimids]
        if is_rec:
            shape[0] = numrecs
            per_rec = strides[nm]
            n_per_rec = per_rec // size
            out = np.empty(numrecs * n_per_rec, dtype=dt)
            for rec in range(numrecs):
                off = begin + rec * recsize
                out[rec * n_per_rec:(rec + 1) * n_per_rec] = np.frombuffer(
                    buf, dtype=dt, count=n_per_rec, offset=off)
            data = out.reshape(shape)
        else:
            count = int(np.prod(shape)) if shape else 1
            data = np.frombuffer(buf, dtype=dt, count=count,
                                 offset=begin).reshape(shape)
        # native byte order copy
        data = np.ascontiguousarray(
            data.astype(data.dtype.newbyteorder("="), copy=False))
        ds.variables[nm] = Variable(dims=dims, data=data, attrs=attrs)

    for nm, ln in zip(dim_names, dim_sizes):
        ds.dims[nm] = numrecs if ln == 0 else ln
    return ds


# --------------------------------------------------------------------------
# writing
# --------------------------------------------------------------------------

def _coerce(data) -> np.ndarray:
    a = np.asarray(data)
    if a.dtype == np.float64 or a.dtype == np.float32:
        pass
    elif a.dtype == np.int64:
        if np.abs(a).max(initial=0) > np.iinfo(np.int32).max:
            raise ValueError("int64 data exceeds NC_INT range (classic "
                             "format has no 64-bit integer type)")
        a = a.astype(np.int32)
    elif a.dtype == np.bool_:
        a = a.astype(np.int8)
    elif a.dtype.kind == "U":
        a = np.char.encode(a, "utf-8").view("S1")
    if a.dtype.str.lstrip("<>=|") not in ("i1", "S1", "i2", "i4",
                                          "f4", "f8"):
        raise TypeError(f"dtype {a.dtype} has no classic netCDF type")
    return a


def _pack_values(w: bytearray, value):
    """Write an attribute value (nc_type, nelems, padded values)."""
    if isinstance(value, (str, bytes)):
        raw = value.encode("utf-8") if isinstance(value, str) else value
        w += struct.pack(">ii", 2, len(raw))
        w += raw + b"\x00" * (_round4(len(raw)) - len(raw))
        return
    a = np.atleast_1d(_coerce(value))
    nc_type = _INV_TYPEMAP[np.dtype(a.dtype.str.lstrip("<>=|"))]
    be = a.astype(_TYPEMAP[nc_type][0])
    raw = be.tobytes()
    w += struct.pack(">ii", nc_type, a.size)
    w += raw + b"\x00" * (_round4(len(raw)) - len(raw))


def _pack_name(w: bytearray, name: str):
    raw = name.encode("utf-8")
    w += struct.pack(">i", len(raw))
    w += raw + b"\x00" * (_round4(len(raw)) - len(raw))


def _pack_attrs(w: bytearray, attrs: Dict[str, object]):
    if not attrs:
        w += _ABSENT
        return
    w += struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))
    for k, v in attrs.items():
        _pack_name(w, k)
        _pack_values(w, v)


def write(path: str, ds: Dataset):
    """Serialize a :class:`Dataset` as CDF-2 (64-bit-offset) classic
    netCDF.  ``ds.record_dim`` (if set) becomes the UNLIMITED dimension;
    variables whose first dim is the record dim are written as record
    variables."""
    dim_names = list(ds.dims)
    dim_index = {nm: i for i, nm in enumerate(dim_names)}

    numrecs = 0
    fixed, record = [], []
    for nm, v in ds.variables.items():
        data = _coerce(v.data)
        if v.dims and ds.record_dim == v.dims[0]:
            record.append((nm, v, data))
            numrecs = max(numrecs, data.shape[0])
        else:
            for dname, s in zip(v.dims, data.shape):
                if ds.dims[dname] != s:
                    raise ValueError(
                        f"variable {nm} axis {dname}: {s} != "
                        f"{ds.dims[dname]}")
            fixed.append((nm, v, data))

    w = bytearray()
    w += _MAGIC2
    w += struct.pack(">I", numrecs)
    if ds.dims:
        w += struct.pack(">ii", _NC_DIMENSION, len(ds.dims))
        for nm in dim_names:
            _pack_name(w, nm)
            w += struct.pack(">i", 0 if nm == ds.record_dim
                             else ds.dims[nm])
    else:
        w += _ABSENT
    _pack_attrs(w, ds.attrs)

    # variable headers: sizes first, offsets after layout
    ordered = fixed + record
    if ordered:
        w += struct.pack(">ii", _NC_VARIABLE, len(ordered))
    else:
        w += _ABSENT

    record_names = {nm for nm, _, _ in record}
    header_offsets = []
    for nm, v, data in ordered:
        _pack_name(w, nm)
        w += struct.pack(">i", len(v.dims))
        for dname in v.dims:
            w += struct.pack(">i", dim_index[dname])
        _pack_attrs(w, v.attrs)
        nc_type = _INV_TYPEMAP[np.dtype(data.dtype.str.lstrip("<>=|"))]
        size = _TYPEMAP[nc_type][1]
        if nm in record_names:
            n = int(np.prod(data.shape[1:])) if data.ndim > 1 else 1
        else:
            n = int(np.prod(data.shape)) if data.ndim else 1
        vsize = _round4(n * size)
        w += struct.pack(">ii", nc_type, vsize)
        header_offsets.append(len(w))
        w += struct.pack(">Q", 0)   # begin, patched below

    # layout: fixed vars, then the record block
    begins = []
    pos = len(w)
    for nm, v, data in fixed:
        begins.append(pos)
        nc_type = _INV_TYPEMAP[np.dtype(data.dtype.str.lstrip("<>=|"))]
        pos += _round4(data.size * _TYPEMAP[nc_type][1])
    rec_start = pos
    rec_strides = []
    for nm, v, data in record:
        begins.append(pos)
        nc_type = _INV_TYPEMAP[np.dtype(data.dtype.str.lstrip("<>=|"))]
        per = (int(np.prod(data.shape[1:])) if data.ndim > 1 else 1) \
            * _TYPEMAP[nc_type][1]
        rec_strides.append(per if len(record) == 1 else _round4(per))
        pos += rec_strides[-1]
    recsize = sum(rec_strides)

    for off, begin in zip(header_offsets, begins):
        w[off:off + 8] = struct.pack(">Q", begin)

    body = bytearray(rec_start - len(w))
    for (nm, v, data), begin in zip(fixed, begins[:len(fixed)]):
        nc_type = _INV_TYPEMAP[np.dtype(data.dtype.str.lstrip("<>=|"))]
        raw = np.ascontiguousarray(
            data.astype(_TYPEMAP[nc_type][0])).tobytes()
        start = begin - len(w)
        body[start:start + len(raw)] = raw

    rec_block = bytearray(recsize * numrecs)
    for (nm, v, data), begin, stride in zip(
            record, begins[len(fixed):], rec_strides):
        nc_type = _INV_TYPEMAP[np.dtype(data.dtype.str.lstrip("<>=|"))]
        be = np.ascontiguousarray(data.astype(_TYPEMAP[nc_type][0]))
        per = (int(np.prod(data.shape[1:])) if data.ndim > 1 else 1) \
            * _TYPEMAP[nc_type][1]
        col = begin - rec_start
        for rec in range(data.shape[0]):
            # slice (not index): indexing a 1-D big-endian array returns
            # a native-endian numpy scalar, which would corrupt the bytes
            raw = be[rec:rec + 1].tobytes()
            rec_block[rec * recsize + col:
                      rec * recsize + col + per] = raw

    with open(path, "wb") as f:
        f.write(bytes(w) + bytes(body) + bytes(rec_block))
