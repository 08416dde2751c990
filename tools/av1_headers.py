"""The headers of the AV1 still pictures that libaom writes for cv2
(a reduced still picture sequence header, one frame OBU), read field by
field with the position of each, and rewritten: ``strip_filters`` sets the
loop filter levels and (or not) the CDEF strengths of a lossy frame to 0,
so that cv2 (libaom) decodes it without those in-loop filters;
``rewrite_loop_filter`` writes other loop filter parameters (levels,
sharpness, the INTRA_FRAME ref delta) and may zero the CDEF strengths
alone; ``rewrite_cdef`` writes the CDEF damping and strengths in place
(their widths are fixed, so neither the OBU's size nor its tiles change);
``fields`` says what a payload switches on (screen content tools and
intra block copy, ``tx_mode_select``, ``delta_q_present``, segmentation
and each segment's features, the loop
filter levels, sharpness and deltas, the CDEF damping, index bits and
strengths, the loop restoration types, unit and chroma shifts, the
quantizer). A frame that allows intra block copy codes no loop filter,
CDEF or loop restoration parameters: they read as off.

    f = fields(payload)
    plain = strip_filters(payload)
    deblocked_only = rewrite_loop_filter(payload, cdef=False)
    stronger = rewrite_cdef(payload, damping=6, strengths=[[9, 3, 2, 1]])
"""

from __future__ import annotations


def _obus(payload: bytes) -> list:
    """[(type, start of the OBU, start of its body, end)] of a payload whose
    OBUs carry sizes and no extension."""
    out, at = [], 0
    while at < len(payload):
        head = payload[at]
        pos, size, shift = at + 1, 0, 0
        while True:
            b = payload[pos]
            size |= (b & 0x7F) << shift
            pos, shift = pos + 1, shift + 7
            if not b & 0x80:
                break
        out.append((head >> 3 & 15, at, pos, pos + size))
        at = pos + size
    return out


def _leb128(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        out.append(b | (0x80 if n else 0))
        if not n:
            return bytes(out)


class _Bits:
    def __init__(self, data: bytes):
        self.bits = "".join(f"{b:08b}" for b in data)
        self.pos = 0

    def f(self, n: int) -> int:
        v = int(self.bits[self.pos : self.pos + n] or "0", 2)
        self.pos += n
        return v

    def su(self, n: int) -> int:
        v = self.f(n)
        return v - (1 << n) if v >> (n - 1) else v


def _sequence(body: bytes) -> dict:
    b = _Bits(body)
    s = {"profile": b.f(3)}
    b.f(1)
    if not b.f(1):
        raise ValueError("a full sequence header: not one libaom writes for cv2")
    b.f(5)
    wb, hb = b.f(4) + 1, b.f(4) + 1
    s["width"], s["height"] = b.f(wb) + 1, b.f(hb) + 1
    s["sb128"], _, _ = b.f(1), b.f(1), b.f(1)
    s["superres"], s["cdef"], s["restoration"] = b.f(1), b.f(1), b.f(1)
    high = b.f(1)
    depth = (12 if b.f(1) else 10) if s["profile"] == 2 and high else 10 if high else 8
    s["mono"] = b.f(1) if s["profile"] != 1 else 0
    cp = tc = mc = 2
    if b.f(1):
        cp, tc, mc = b.f(8), b.f(8), b.f(8)
    s["separate_uv_delta_q"] = 0
    if s["mono"]:
        b.f(1)
    elif (cp, tc, mc) == (1, 13, 0):  # sRGB: full range 4:4:4, nothing read
        s["separate_uv_delta_q"] = b.f(1)
    else:
        b.f(1)  # color_range
        if s["profile"] == 2 and depth == 12:
            ssx = b.f(1)
            ssy = b.f(1) if ssx else 0
            s["subsampling"] = (ssx, ssy)
            if ssx and ssy:
                b.f(2)  # chroma_sample_position
        elif s["profile"] == 0:
            b.f(2)  # chroma_sample_position
        s["separate_uv_delta_q"] = b.f(1)
    if "subsampling" not in s:  # monochrome, sRGB (4:4:4), or what the profile implies
        srgb = (cp, tc, mc) == (1, 13, 0)
        s["subsampling"] = (1, 1) if s["mono"] else (0, 0) if srgb else ((1, 1), (0, 0), (1, 0))[s["profile"]]
    s["film_grain"] = b.f(1)
    s["depth"] = depth
    return s


def fields(payload: bytes) -> dict:
    """The frame header fields of a cv2 payload, and ``bit`` positions
    (within the frame OBU's body) of the loop filter and CDEF parameters
    and of the header's end."""
    obus = {t: (s, e) for t, _, s, e in _obus(payload)}
    seq = _sequence(payload[obus[1][0] : obus[1][1]])
    s, e = obus[6]
    b = _Bits(payload[s:e])
    out = dict(seq)
    b.f(1)  # disable_cdf_update
    out["screen_content"] = b.f(1)  # allow_screen_content_tools
    out["force_integer_mv"] = b.f(1) if out["screen_content"] else 0  # SELECT_INTEGER_MV in a reduced header
    if seq["superres"] and b.f(1):
        raise ValueError("superres")
    if b.f(1):  # render_and_frame_size_different
        b.f(32)
    out["intrabc"] = b.f(1) if out["screen_content"] else 0  # allow_intrabc
    mi_cols, mi_rows = 2 * ((seq["width"] + 7) >> 3), 2 * ((seq["height"] + 7) >> 3)
    sb_shift = 5 if seq["sb128"] else 4
    sb_cols, sb_rows = (mi_cols + (1 << sb_shift) - 1) >> sb_shift, (mi_rows + (1 << sb_shift) - 1) >> sb_shift

    def tile_log2(blk, target):
        k = 0
        while (blk << k) < target:
            k += 1
        return k

    sb_size = sb_shift + 2
    max_w = 4096 >> sb_size
    min_cols, max_cols = tile_log2(max_w, sb_cols), tile_log2(1, min(sb_cols, 64))
    max_rows = tile_log2(1, min(sb_rows, 64))
    min_tiles = max(min_cols, tile_log2((4096 * 2304) >> (2 * sb_size), sb_rows * sb_cols))
    if b.f(1):  # uniform_tile_spacing_flag
        cols_log2 = min_cols
        while cols_log2 < max_cols and b.f(1):
            cols_log2 += 1
        rows_log2 = max(min_tiles - cols_log2, 0)
        while rows_log2 < max_rows and b.f(1):
            rows_log2 += 1
    else:
        raise ValueError("non-uniform tiles")
    if cols_log2 or rows_log2:
        b.f(cols_log2 + rows_log2)
        b.f(2)
    out["tiles_log2"] = (cols_log2, rows_log2)
    out["base_q_idx"] = b.f(8)

    def delta():
        return b.su(7) if b.f(1) else 0

    out["delta_q_y_dc"] = delta()
    out["delta_q_uv"] = (0, 0)
    if not seq["mono"]:
        diff = b.f(1) if seq["separate_uv_delta_q"] else 0
        out["delta_q_uv"] = (delta(), delta())
        if diff:
            delta(), delta()
    out["using_qmatrix"] = b.f(1)
    if out["using_qmatrix"]:
        out["qm"] = (b.f(4), b.f(4), b.f(4) if seq["separate_uv_delta_q"] else None)
    # segmentation_params of a key frame: per segment, {SEG_LVL_* index: its data, clamped}
    out["segmentation"], out["seg_features"] = b.f(1), [{} for _ in range(8)]
    if out["segmentation"]:
        for f in out["seg_features"]:
            for j, (bits, signed, mx) in enumerate(zip((8, 6, 6, 6, 6, 3, 0, 0), (1, 1, 1, 1, 1, 0, 0, 0),
                                                       (255, 63, 63, 63, 63, 7, 0, 0))):
                if b.f(1):
                    f[j] = max(-mx, min(mx, b.su(bits + 1) if signed else b.f(bits)))
    out["delta_q_present"] = b.f(1) if out["base_q_idx"] else 0
    out["delta_q_res"] = b.f(2) if out["delta_q_present"] else 0
    out["delta_lf_present"] = b.f(1) if out["delta_q_present"] and not out["intrabc"] else 0
    out["delta_lf_res"], out["delta_lf_multi"] = (b.f(2), b.f(1)) if out["delta_lf_present"] else (0, 0)
    # CodedLossless: every segment's quantizer (base_q_idx plus ALT_Q) 0, and every delta q 0
    qindex = [min(255, max(0, out["base_q_idx"] + f.get(0, 0))) for f in out["seg_features"]]
    lossless = all(v == 0 for v in qindex) and out["delta_q_y_dc"] == 0 and out["delta_q_uv"] == (0, 0)
    out["loop_filter"], out["cdef_strengths"], out["tx_mode_select"] = (0, 0), [], 0
    out["lr_type"], out["lr_unit_shift"], out["lr_uv_shift"] = (0,) * (1 if seq["mono"] else 3), 0, 0
    if not lossless and not out["intrabc"]:
        out["bit_lf"] = b.pos
        out["loop_filter"] = (b.f(6), b.f(6))
        if not seq["mono"] and any(out["loop_filter"]):
            out["loop_filter_uv"] = (b.f(6), b.f(6))
        out["sharpness"] = b.f(3)
        out["bit_lf_deltas"] = b.pos
        out["lf_delta_enabled"], out["lf_deltas"] = b.f(1), {}
        if out["lf_delta_enabled"] and b.f(1):
            for i in range(10):  # eight ref deltas, then two mode deltas
                if b.f(1):
                    out["lf_deltas"][i] = b.su(7)
        out["bit_lf_params_end"] = b.pos
        if seq["cdef"]:
            out["bit_cdef_damping"] = b.pos
            out["cdef_damping"] = b.f(2) + 3
            out["cdef_bits"] = b.f(2)
            out["bit_cdef"] = b.pos
            for _ in range(1 << out["cdef_bits"]):
                strength = [b.f(4), b.f(2)] + ([] if seq["mono"] else [b.f(4), b.f(2)])
                out["cdef_strengths"].append(strength)
            out["bit_cdef_end"] = b.pos
        # lr_params: lr_type per plane as coded (0 NONE, 1 SWITCHABLE, 2 WIENER, 3 SGRPROJ), lr_unit_shift as the
        # specification takes it (units of 256 >> (2 - shift) luma samples) and lr_uv_shift
        if seq["restoration"]:
            out["bit_lr"] = b.pos
            out["lr_type"] = tuple(b.f(2) for _ in range(1 if seq["mono"] else 3))
            if any(out["lr_type"]):
                shift = b.f(1)
                if seq["sb128"]:
                    shift += 1
                elif shift:
                    shift += b.f(1)
                out["lr_unit_shift"] = shift
                if seq["subsampling"] == (1, 1) and any(out["lr_type"][1:]):
                    out["lr_uv_shift"] = b.f(1)
            out["bit_lr_end"] = b.pos
    if not lossless:
        out["tx_mode_select"] = b.f(1)
    out["reduced_tx_set"] = b.f(1)
    if seq["film_grain"] and b.f(1):
        raise ValueError("film grain")
    out["bit_end"] = b.pos
    return out


def strip_filters(payload: bytes, keep_cdef: bool = False, keep_loop_filter: bool = False) -> bytes:
    """A cv2 payload whose frame header is rewritten with loop filter
    levels 0 (so no level for U and V) and, unless ``keep_cdef``, CDEF
    strengths 0; with ``keep_loop_filter``, the CDEF strengths alone are
    set to 0. The tile data is kept (neither changes its syntax) after
    the header's new byte alignment."""
    if "bit_lf" not in fields(payload):  # a lossless frame: no filter parameters
        return payload
    return rewrite_loop_filter(payload, levels=None if keep_loop_filter else (0, 0, 0, 0), cdef=keep_cdef)


def rewrite_cdef(payload: bytes, damping=None, strengths=None) -> bytes:
    """A cv2 payload whose CDEF damping (3-6) and strength entries are
    rewritten in place: ``strengths`` holds one entry per CDEF index of the
    frame (``1 << cdef_bits``), each [Y primary 0-15, Y secondary 0-3] and,
    where the frame has chroma, [UV primary, UV secondary] after them;
    None keeps what the frame has."""
    f = fields(payload)
    if "bit_cdef" not in f:
        raise ValueError("a frame without CDEF parameters")
    _, _, s, e = next(o for o in _obus(payload) if o[0] == 6)
    bits = list("".join(f"{x:08b}" for x in payload[s:e]))
    if damping is not None:
        if not 3 <= damping <= 6:
            raise ValueError(f"CDEF damping {damping} outside 3-6")
        bits[f["bit_cdef_damping"] : f["bit_cdef_damping"] + 2] = f"{damping - 3:02b}"
    if strengths is not None:
        per = 2 if f["mono"] else 4
        if len(strengths) != 1 << f["cdef_bits"] or any(len(v) != per for v in strengths):
            raise ValueError(f"{1 << f['cdef_bits']} CDEF entries of {per} strengths wanted")
        field = "".join(f"{v[k]:0{4 if k % 2 == 0 else 2}b}" for v in strengths for k in range(per))
        if len(field) != f["bit_cdef_end"] - f["bit_cdef"]:
            raise ValueError("a strength outside its field (primary 0-15, secondary 0-3)")
        bits[f["bit_cdef"] : f["bit_cdef_end"]] = field
    body = int("".join(bits), 2).to_bytes(e - s, "big")
    return payload[:s] + body + payload[e:]


def _su(v: int, n: int) -> str:
    return f"{v & ((1 << n) - 1):0{n}b}"


def rewrite_loop_filter(payload: bytes, levels=None, sharpness=None, ref_delta_intra=None, cdef: bool = True) -> bytes:
    """A cv2 payload whose loop filter parameters are rewritten:
    ``levels`` (Y vertical, Y horizontal, U, V; U and V are written only
    where the frame has chroma and level 0 or 1 is not 0), ``sharpness``
    (0-7) and, with ``ref_delta_intra``, loop_filter_delta_enabled and
    _update set and the INTRA_FRAME ref delta written (the others left at
    their defaults); None keeps what the frame has. Unless ``cdef``, the
    CDEF strengths are set to 0. The tile data is kept after the header's
    new byte alignment."""
    f = fields(payload)
    if "bit_lf" not in f:
        raise ValueError("a lossless frame: no loop filter parameters")
    _, start, s, e = next(o for o in _obus(payload) if o[0] == 6)
    bits = "".join(f"{x:08b}" for x in payload[s:e])
    lv = tuple(levels) if levels is not None else tuple(f["loop_filter"]) + tuple(f.get("loop_filter_uv", (0, 0)))
    lf = f"{lv[0]:06b}{lv[1]:06b}"
    if not f["mono"] and (lv[0] or lv[1]):
        lf += f"{lv[2]:06b}{lv[3]:06b}"
    lf += f"{f['sharpness'] if sharpness is None else sharpness:03b}"
    if ref_delta_intra is None:
        lf += bits[f["bit_lf_deltas"] : f["bit_lf_params_end"]]
    else:  # enabled, updated: the INTRA_FRAME ref delta, no other
        lf += "111" + _su(ref_delta_intra, 7) + "0" * 9
    header = bits[: f["bit_lf"]] + lf + bits[f["bit_lf_params_end"] : f["bit_end"]]
    if "bit_cdef" in f and not cdef:
        at, n = f["bit_cdef"] + len(lf) - (f["bit_lf_params_end"] - f["bit_lf"]), f["bit_cdef_end"] - f["bit_cdef"]
        header = header[:at] + "0" * n + header[at + n :]
    header += "0" * (-len(header) % 8)
    tiles = payload[s + (f["bit_end"] + 7) // 8 : e]
    body = int(header, 2).to_bytes(len(header) // 8, "big") + tiles
    return payload[:start] + bytes([6 << 3 | 2]) + _leb128(len(body)) + body + payload[e:]

