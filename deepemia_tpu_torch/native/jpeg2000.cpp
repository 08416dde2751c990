// JPEG 2000 Part 1 codestream decoder of read_image (C ABI, ctypes-loaded by
// deepemia_tpu_torch/native/__init__.py), step for step as OpenJPEG 2.5
// (OpenCV 5.0's) decodes, so that the samples are those cv2.imread converts:
// the main and tile-part headers (SIZ, COD/COC, QCD/QCC, RGN, POC, PPM/PPT;
// TLM, PLM, PLT, CRG, COM and unknown markers skipped), the packet iterator
// of the five progression orders with POC changes and the include table,
// packet headers (tag trees, SOP and EPH), the MQ decoder and the three
// coding passes with every code-block style switch, the ROI max-shift,
// dequantisation at the mid-point of the last decoded bit-plane, the inverse
// 5/3 in integers and the inverse 9/7 in float32 in OpenJPEG's lifting order
// and constants, the inverse RCT and ICT, and the DC level shift with lrintf.
// The JP2 boxes, the palette, the channel definitions and OpenCV's last step
// are ops/jpeg2000.py's.
//
// Built on first use: g++ -O2 -shared -fPIC jpeg2000.cpp -o
// build/torch_native/libjpeg2000-<hash>.so. The float path must round as
// OpenJPEG's SSE code rounds on every host, so no product is contracted into
// a fused multiply-add (the pragma below; x86-64's baseline has no FMA, but
// an aarch64 host's compiler would contract by default).
//
// j2k_decode(data, size, out, out_size, meta, meta_size): a codestream (from
// its SOC marker) -> status. With out NULL it reads the main header only and
// returns 1; meta = (components, x1, y1, x0, y0, then per component
// precision, signed, dx, dy). With out, it decodes every tile into out
// [component][height][width] int32 (each component's own size, ceil(x1/dx) -
// ceil(x0/dx) by ceil(y1/dy) - ceil(y0/dy), in turn) and returns 0. A
// negative status: -1 a codestream OpenJPEG fails on (corrupt, cut short, or
// out of its limits), -2 a High-Throughput (Part 15) codestream, -3 a Part 2
// marker (MCT, MCC, MCO, CBD, ADS, ATK, NLT, DCO), which this decoder does
// not cover. A High-Throughput codestream is one whose COD or COC sets the HT
// code-block style: a CAP marker or an Rsiz that names Part 15 over Part 1
// code-blocks is read as OpenJPEG reads it, as Part 1.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <vector>

namespace {

struct Fail {
    int status;
};

[[noreturn]] void fail(int status = -1) { throw Fail{status}; }

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceildivpow2(int64_t a, int b) { return (a + ((int64_t)1 << b) - 1) >> b; }
int64_t floordivpow2(int64_t a, int b) { return a >> b; }

// ---------------------------------------------------------------------------
// Coding parameters
// ---------------------------------------------------------------------------

const int kMaxRes = 33;
const int kMaxBands = 3 * kMaxRes - 2;

struct CompSiz {
    int prec = 0, sgnd = 0, dx = 1, dy = 1;
};

struct StepSize {
    int expn = 0, mant = 0;
};

struct TCCP {  // one tile-component's coding style (COD/COC) and quantisation (QCD/QCC)
    int numres = 1, cbw = 6, cbh = 6, cblksty = 0, qmfbid = 0;
    int prcw[kMaxRes], prch[kMaxRes];
    int qntsty = 0, numgbits = 0;
    StepSize steps[kMaxBands];
    int roishift = 0;
    TCCP() {
        for (int i = 0; i < kMaxRes; ++i) prcw[i] = prch[i] = 15;
    }
};

struct Poc {
    int res0, comp0, lay1, res1, comp1, prg;
};

struct TCP {  // one tile's coding parameters and the data of its tile-parts
    int csty = 0, prg = 0, numlayers = 1, mct = 0;
    std::vector<TCCP> tccps;
    std::vector<Poc> pocs;
    std::map<int, std::vector<uint8_t>> ppt;
    std::vector<uint8_t> data;
    int nparts = 0;
    bool seen = false;  // some tile-part of this tile held data
};

struct Image {
    int64_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
    int64_t tx0 = 0, ty0 = 0, tdx = 0, tdy = 0;
    int tw = 0, th = 0;
    std::vector<CompSiz> comps;
};

struct Reader {
    const uint8_t* p;
    size_t n, pos = 0;
    Reader(const uint8_t* p_, size_t n_) : p(p_), n(n_) {}
    size_t left() const { return n - pos; }
    uint32_t get(int bytes) {
        if (pos + bytes > n) fail();
        uint32_t v = 0;
        for (int i = 0; i < bytes; ++i) v = (v << 8) | p[pos++];
        return v;
    }
};

// ---------------------------------------------------------------------------
// Marker segments (j2k.c)
// ---------------------------------------------------------------------------

struct Codestream {
    Image img;
    TCP deflt;
    std::vector<TCP> tcps;
    std::map<int, std::vector<uint8_t>> ppm_markers;
    bool ppm = false;
    std::vector<uint8_t> ppm_data;
    size_t ppm_pos = 0;
    std::vector<int> resno_decoded;  // per component, the highest resolution a packet was read for, over every tile
};

// SPcod / SPcoc into a tile-component (opj_j2k_read_SPCod_SPCoc)
void read_spcod(Reader& r, size_t end, TCCP& t, bool precincts) {
    if (r.pos + 5 > end) fail();
    t.numres = (int)r.get(1) + 1;
    if (t.numres > kMaxRes) fail();
    t.cbw = (int)r.get(1) + 2;
    t.cbh = (int)r.get(1) + 2;
    if (t.cbw > 10 || t.cbh > 10 || t.cbw + t.cbh > 12) fail();
    t.cblksty = (int)r.get(1);
    if (t.cblksty & 0x80) fail();  // mixed HT and Part 1 code-blocks, which OpenJPEG refuses
    // HT code-blocks (Part 15), which OpenJPEG decodes by this bit whatever the CAP marker or the file's brand say
    if (t.cblksty & 0x40) fail(-2);
    t.qmfbid = (int)r.get(1);
    if (t.qmfbid > 1) fail();
    if (precincts) {
        if (r.pos + t.numres > end) fail();
        for (int i = 0; i < t.numres; ++i) {
            int v = (int)r.get(1);
            t.prcw[i] = v & 15;
            t.prch[i] = v >> 4;
            if (i != 0 && (t.prcw[i] == 0 || t.prch[i] == 0)) fail();
        }
    } else {
        for (int i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
    }
}

// SQcd / SQcc into a tile-component (opj_j2k_read_SQcd_SQcc): one byte a band without quantisation, two
// with any other style (styles past 2 too), and not a byte left over (an error of the QCD or QCC reader)
void read_sqcd(Reader& r, size_t end, TCCP& t) {
    if (r.pos + 1 > end) fail();
    int v = (int)r.get(1);
    t.qntsty = v & 31;
    t.numgbits = v >> 5;
    size_t len = end - r.pos;
    size_t nbands = t.qntsty == 1 ? 1 : t.qntsty == 0 ? len : len / 2;
    if ((t.qntsty == 0 ? nbands : 2 * nbands) != len) fail();
    for (size_t b = 0; b < nbands; ++b) {  // past kMaxBands OpenJPEG warns and skips the rest
        int e, m = 0;
        if (t.qntsty == 0) {
            e = (int)r.get(1) >> 3;
        } else {
            int s = (int)r.get(2);
            e = s >> 11;
            m = s & 0x7ff;
        }
        if (b < (size_t)kMaxBands) t.steps[b] = StepSize{e, m};
    }
    if (t.qntsty == 1) {  // scalar derived: the exponent falls by one a decomposition level
        for (int b = 1; b < kMaxBands; ++b) {
            int e = t.steps[0].expn - (b - 1) / 3;
            t.steps[b].expn = e > 0 ? e : 0;
            t.steps[b].mant = t.steps[0].mant;
        }
    }
}

int comp_index(Reader& r, const Image& img) {
    int c = (int)r.get(img.comps.size() <= 256 ? 1 : 2);
    if (c >= (int)img.comps.size()) fail();
    return c;
}

// one marker segment of the main header (tile == nullptr) or of a tile-part header
void read_marker(Codestream& cs, int marker, Reader& r, size_t end, TCP* tile) {
    Image& img = cs.img;
    TCP& tcp = tile ? *tile : cs.deflt;
    switch (marker) {
    case 0xFF52: {  // COD
        int csty = (int)r.get(1);
        if (csty > 7) fail();
        tcp.csty = csty;
        tcp.prg = (int)r.get(1);
        if (tcp.prg > 4) tcp.prg = -1;  // "Unknown progression order": a tile decoded in it fails
        tcp.numlayers = (int)r.get(2);
        if (tcp.numlayers < 1) fail();
        tcp.mct = (int)r.get(1);
        if (tcp.mct > 1) fail();
        if (tcp.mct && img.comps.size() < 3) fail();
        TCCP t = tcp.tccps[0];
        read_spcod(r, end, t, (csty & 1) != 0);
        if (r.pos != end) fail();
        for (auto& tc : tcp.tccps) {  // every component takes it (opj_j2k_copy_tile_component_parameters)
            int qntsty = tc.qntsty, numgbits = tc.numgbits, roishift = tc.roishift;
            StepSize steps[kMaxBands];
            std::memcpy(steps, tc.steps, sizeof(steps));
            tc = t;
            tc.qntsty = qntsty;
            tc.numgbits = numgbits;
            tc.roishift = roishift;
            std::memcpy(tc.steps, steps, sizeof(steps));
        }
        break;
    }
    case 0xFF53: {  // COC
        int c = comp_index(r, img);
        int csty = (int)r.get(1);
        read_spcod(r, end, tcp.tccps[c], (csty & 1) != 0);
        if (r.pos != end) fail();
        break;
    }
    case 0xFF5C: {  // QCD
        TCCP t = tcp.tccps[0];
        read_sqcd(r, end, t);
        for (auto& tc : tcp.tccps) {
            tc.qntsty = t.qntsty;
            tc.numgbits = t.numgbits;
            std::memcpy(tc.steps, t.steps, sizeof(t.steps));
        }
        break;
    }
    case 0xFF5D: {  // QCC
        int c = comp_index(r, img);
        read_sqcd(r, end, tcp.tccps[c]);
        break;
    }
    case 0xFF5E: {  // RGN (its style is not checked)
        int c = comp_index(r, img);
        r.get(1);
        tcp.tccps[c].roishift = (int)r.get(1);
        if (r.pos != end) fail();
        break;
    }
    case 0xFF5F: {  // POC: appended to those read before, 32 at most; the order is not checked
        int cbytes = img.comps.size() <= 256 ? 1 : 2;
        size_t each = 5 + 2 * cbytes;
        size_t n = (end - r.pos) / each;
        if (n == 0 || (end - r.pos) % each) fail();
        if (tcp.pocs.size() + n >= 32) fail();
        for (size_t i = 0; i < n; ++i) {
            Poc p;
            p.res0 = (int)r.get(1);
            p.comp0 = (int)r.get(cbytes);
            p.lay1 = (int)r.get(2);
            p.res1 = (int)r.get(1);
            p.comp1 = std::min<int>((int)r.get(cbytes), (int)img.comps.size());
            p.prg = (int)r.get(1);
            tcp.pocs.push_back(p);
        }
        break;
    }
    case 0xFF60: {  // PPM
        if (tile) fail();
        int z = (int)r.get(1);
        if (cs.ppm_markers.count(z)) fail();
        cs.ppm_markers[z] = std::vector<uint8_t>(r.p + r.pos, r.p + end);
        cs.ppm = true;
        r.pos = end;
        break;
    }
    case 0xFF61: {  // PPT
        if (!tile) fail();
        if (cs.ppm) fail();
        int z = (int)r.get(1);
        if (tile->ppt.count(z)) fail();
        tile->ppt[z] = std::vector<uint8_t>(r.p + r.pos, r.p + end);
        r.pos = end;
        break;
    }
    case 0xFF74: case 0xFF75: case 0xFF77: case 0xFF78: case 0xFF63: case 0xFF73: case 0xFF76: case 0xFF70:
        fail(-3);  // MCT, MCC, MCO, CBD, ADS, ATK, NLT, DCO (Part 2)
    default:  // TLM, PLM, PLT, CRG, COM and markers OpenJPEG does not know: skipped
        r.pos = end;
        break;
    }
}

void read_siz(Codestream& cs, Reader& r, size_t end) {
    Image& img = cs.img;
    r.get(2);  // Rsiz: the capabilities OpenJPEG does not hold the decoder to
    img.x1 = r.get(4);
    img.y1 = r.get(4);
    img.x0 = r.get(4);
    img.y0 = r.get(4);
    img.tdx = r.get(4);
    img.tdy = r.get(4);
    img.tx0 = r.get(4);
    img.ty0 = r.get(4);
    int nc = (int)r.get(2);
    if (end - r.pos != (size_t)nc * 3 || nc < 1 || nc > 16384) fail();
    if (img.x0 >= img.x1 || img.y0 >= img.y1) fail();
    if (img.tdx == 0 || img.tdy == 0) fail();
    if (img.tx0 > img.x0 || img.ty0 > img.y0 || img.tx0 + img.tdx <= img.x0 || img.ty0 + img.tdy <= img.y0) fail();
    img.comps.resize(nc);
    for (auto& c : img.comps) {
        int s = (int)r.get(1);
        c.prec = (s & 0x7f) + 1;
        c.sgnd = s >> 7;
        c.dx = (int)r.get(1);
        c.dy = (int)r.get(1);
        if (c.dx < 1 || c.dy < 1) fail();
        if (c.prec > 31) fail();
    }
    img.tw = (int)ceildiv(img.x1 - img.tx0, img.tdx);
    img.th = (int)ceildiv(img.y1 - img.ty0, img.tdy);
    if ((int64_t)img.tw * img.th > 65535 || img.tw <= 0 || img.th <= 0) fail();
    cs.deflt.tccps.assign(nc, TCCP());
}

// where each marker OpenJPEG's decoder knows may stand (j2k_memory_marker_handler_tab), or -1 for one it
// does not know (SOD, EOC and EPH among them)
enum { kSizState = 1, kMainState = 2, kSotState = 4, kTileState = 8 };

int marker_states(int m) {
    switch (m) {
    case 0xFF90: return kMainState | kSotState;                                      // SOT
    case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D: case 0xFF5F:    // COD COC RGN QCD QCC POC
    case 0xFF64: case 0xFF74: case 0xFF75: case 0xFF77:                              // COM MCT MCC MCO
        return kMainState | kTileState;
    case 0xFF51: return kSizState;                                                   // SIZ
    case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63: case 0xFF78: case 0xFF50: case 0xFF59:
        return kMainState;                                                           // TLM PLM PPM CRG CBD CAP CPF
    case 0xFF58: case 0xFF61: return kTileState;                                     // PLT PPT
    case 0xFF91: return 0;                                                           // SOP: never in a header
    default: return -1;
    }
}

// a marker m just read, as the headers' readers take it: below 0xff00 fails; one OpenJPEG does not know is
// passed over two bytes at a time to the next it does (opj_j2k_read_unk); one out of its place fails
int resolve_marker(Reader& r, int m, int state) {
    if (m < 0xFF00) fail();
    if (marker_states(m) < 0) {
        if (!(state & (kMainState | kTileState))) fail();
        do {
            if (r.left() < 2) fail();
            m = (int)r.get(2);
        } while (m < 0xFF00 || marker_states(m) < 0);
    }
    if (!(marker_states(m) & state)) fail();
    return m;
}

// the main header, from SOC to the first SOT; returns the offset after that SOT's marker code
size_t read_main_header(Codestream& cs, Reader& r) {
    if (r.get(2) != 0xFF4F) fail();
    bool cod = false, qcd = false;
    int state = kSizState;
    for (;;) {
        if (r.left() < 2) fail();  // "Stream too short"
        int marker = resolve_marker(r, (int)r.get(2), state);
        if (marker == 0xFF90) {
            if (!cod || !qcd) fail();
            return r.pos;
        }
        if (r.left() < 2) fail();
        size_t len = r.get(2);
        if (len < 2 || r.pos + len - 2 > r.n) fail();
        size_t end = r.pos + len - 2;
        if (marker == 0xFF51) {
            read_siz(cs, r, end);
            state = kMainState;
        } else {
            if (marker == 0xFF52) cod = true;
            if (marker == 0xFF5C) qcd = true;
            read_marker(cs, marker, r, end, nullptr);
        }
        r.pos = end;
    }
}

// the PPM markers' Ippm, in Zppm order, without their Nppm fields (opj_j2k_merge_ppm)
void merge_ppm(Codestream& cs) {
    uint32_t remaining = 0;
    for (auto& kv : cs.ppm_markers) {
        const auto& d = kv.second;
        size_t i = 0;
        while (i < d.size()) {
            if (remaining) {
                size_t take = std::min<size_t>(remaining, d.size() - i);
                cs.ppm_data.insert(cs.ppm_data.end(), d.begin() + i, d.begin() + i + take);
                remaining -= (uint32_t)take;
                i += take;
                continue;
            }
            if (d.size() - i < 4) fail();  // "Not enough bytes to read Nppm"
            remaining = (uint32_t)d[i] << 24 | (uint32_t)d[i + 1] << 16 | (uint32_t)d[i + 2] << 8 | d[i + 3];
            i += 4;
        }
    }
    if (remaining) fail();
}

// ---------------------------------------------------------------------------
// Tile structures (tcd.c)
// ---------------------------------------------------------------------------

struct TagTree {
    struct Node {
        int parent, value, low;
    };
    std::vector<Node> nodes;
    void init(int w, int h) {
        nodes.clear();
        if (w <= 0 || h <= 0) return;
        std::vector<int> lw, lh;
        int nw = w, nh = h, total = 0;
        for (;;) {
            lw.push_back(nw);
            lh.push_back(nh);
            total += nw * nh;
            if (nw * nh <= 1) break;
            nw = (nw + 1) / 2;
            nh = (nh + 1) / 2;
        }
        nodes.assign(total, Node{-1, 999, 0});
        int base = 0;
        for (size_t l = 0; l + 1 < lw.size(); ++l) {
            int next = base + lw[l] * lh[l];
            for (int j = 0; j < lh[l]; ++j)
                for (int i = 0; i < lw[l]; ++i) nodes[base + j * lw[l] + i].parent = next + (j / 2) * lw[l + 1] + i / 2;
            base = next;
        }
    }
};

struct Seg {
    int len = 0, numpasses = 0, maxpasses = 0, newlen = 0, numnewpasses = 0;
};

struct Cblk {
    int x0, y0, x1, y1;
    int numbps = 0, numlenbits = 0, numnewpasses = 0;
    std::vector<Seg> segs;
    int numsegs = 0;
    std::vector<uint8_t> data;
};

struct Prc {
    int64_t x0, y0, x1, y1;
    int cw = 0, ch = 0;
    std::vector<Cblk> cblks;
    TagTree incl, imsb;
};

struct Band {
    int64_t x0, y0, x1, y1;
    int bandno = 0, numbps = 0;
    float stepsize = 0;
    std::vector<Prc> prcs;
    bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
    int64_t x0, y0, x1, y1;
    int pdx, pdy, pw, ph, numbands;
    Band bands[3];
};

struct TileComp {
    int64_t x0, y0, x1, y1;
    int numres;
    std::vector<Res> res;
    std::vector<int32_t> idata;
    std::vector<float> fdata;
};

void init_tile(const Image& img, const TCP& tcp, int tileno, std::vector<TileComp>& tcs, int64_t t[4]) {
    int p = tileno % img.tw, q = tileno / img.tw;
    t[0] = std::max(img.tx0 + p * img.tdx, img.x0);
    t[1] = std::max(img.ty0 + q * img.tdy, img.y0);
    t[2] = std::min(img.tx0 + (p + 1) * img.tdx, img.x1);
    t[3] = std::min(img.ty0 + (q + 1) * img.tdy, img.y1);
    tcs.resize(img.comps.size());
    for (size_t c = 0; c < img.comps.size(); ++c) {
        const CompSiz& cz = img.comps[c];
        const TCCP& tc = tcp.tccps[c];
        TileComp& tcm = tcs[c];
        tcm.x0 = ceildiv(t[0], cz.dx);
        tcm.y0 = ceildiv(t[1], cz.dy);
        tcm.x1 = ceildiv(t[2], cz.dx);
        tcm.y1 = ceildiv(t[3], cz.dy);
        tcm.numres = tc.numres;
        tcm.res.assign(tc.numres, Res());
        // OpenJPEG requires that every resolution have a non-empty grid of at most 2^32 samples: the level count
        // must leave the smallest resolution at least a sample, else its decomposition fails
        for (int r = 0; r < tc.numres; ++r) {
            Res& rs = tcm.res[r];
            int levelno = tc.numres - 1 - r;
            rs.x0 = ceildivpow2(tcm.x0, levelno);
            rs.y0 = ceildivpow2(tcm.y0, levelno);
            rs.x1 = ceildivpow2(tcm.x1, levelno);
            rs.y1 = ceildivpow2(tcm.y1, levelno);
            rs.pdx = tc.prcw[r];
            rs.pdy = tc.prch[r];
            int64_t prx0 = floordivpow2(rs.x0, rs.pdx) << rs.pdx;
            int64_t pry0 = floordivpow2(rs.y0, rs.pdy) << rs.pdy;
            int64_t prx1 = ceildivpow2(rs.x1, rs.pdx) << rs.pdx;
            int64_t pry1 = ceildivpow2(rs.y1, rs.pdy) << rs.pdy;
            rs.pw = rs.x0 == rs.x1 ? 0 : (int)((prx1 - prx0) >> rs.pdx);
            rs.ph = rs.y0 == rs.y1 ? 0 : (int)((pry1 - pry0) >> rs.pdy);
            if ((int64_t)rs.pw * rs.ph > (1 << 24)) fail();
            int64_t cbgx0, cbgy0;
            int cbgw, cbgh;
            if (r == 0) {
                cbgx0 = prx0;
                cbgy0 = pry0;
                cbgw = rs.pdx;
                cbgh = rs.pdy;
                rs.numbands = 1;
            } else {
                cbgx0 = ceildivpow2(prx0, 1);
                cbgy0 = ceildivpow2(pry0, 1);
                cbgw = rs.pdx - 1;
                cbgh = rs.pdy - 1;
                rs.numbands = 3;
            }
            int cblkw = std::min(tc.cbw, cbgw), cblkh = std::min(tc.cbh, cbgh);
            for (int b = 0; b < rs.numbands; ++b) {
                Band& bd = rs.bands[b];
                bd.bandno = r == 0 ? 0 : b + 1;
                if (r == 0) {
                    bd.x0 = rs.x0;
                    bd.y0 = rs.y0;
                    bd.x1 = rs.x1;
                    bd.y1 = rs.y1;
                } else {
                    int x0b = bd.bandno & 1, y0b = bd.bandno >> 1;
                    int nb = tc.numres - r;  // levelno + 1
                    bd.x0 = ceildivpow2(tcm.x0 - ((int64_t)x0b << (nb - 1)), nb);
                    bd.y0 = ceildivpow2(tcm.y0 - ((int64_t)y0b << (nb - 1)), nb);
                    bd.x1 = ceildivpow2(tcm.x1 - ((int64_t)x0b << (nb - 1)), nb);
                    bd.y1 = ceildivpow2(tcm.y1 - ((int64_t)y0b << (nb - 1)), nb);
                }
                int stepno = r == 0 ? 0 : 3 * (r - 1) + b + 1;
                const StepSize& ss = tc.steps[stepno];
                // BUG_WEIRD_TWO_INVK: the decoder takes no gain for any band of the 9/7 path
                int log2_gain = tc.qmfbid == 0 ? 0 : bd.bandno == 0 ? 0 : bd.bandno == 3 ? 2 : 1;
                int rb = cz.prec + log2_gain;
                bd.stepsize = (float)((1.0 + ss.mant / 2048.0) * std::pow(2.0, (int)(rb - ss.expn))) * 1.0f;
                bd.numbps = ss.expn + tc.numgbits - 1;
                bd.prcs.clear();
                if (bd.empty()) continue;
                bd.prcs.resize((size_t)rs.pw * rs.ph);
                for (int pn = 0; pn < rs.pw * rs.ph; ++pn) {
                    Prc& pr = bd.prcs[pn];
                    int64_t sx = cbgx0 + (int64_t)(pn % rs.pw) * ((int64_t)1 << cbgw);
                    int64_t sy = cbgy0 + (int64_t)(pn / rs.pw) * ((int64_t)1 << cbgh);
                    pr.x0 = std::max(sx, bd.x0);
                    pr.y0 = std::max(sy, bd.y0);
                    pr.x1 = std::min(sx + ((int64_t)1 << cbgw), bd.x1);
                    pr.y1 = std::min(sy + ((int64_t)1 << cbgh), bd.y1);
                    int64_t cx0 = floordivpow2(pr.x0, cblkw) << cblkw;
                    int64_t cy0 = floordivpow2(pr.y0, cblkh) << cblkh;
                    int64_t cx1 = ceildivpow2(pr.x1, cblkw) << cblkw;
                    int64_t cy1 = ceildivpow2(pr.y1, cblkh) << cblkh;
                    pr.cw = cx1 > cx0 ? (int)((cx1 - cx0) >> cblkw) : 0;
                    pr.ch = cy1 > cy0 ? (int)((cy1 - cy0) >> cblkh) : 0;
                    if (pr.x0 >= pr.x1 || pr.y0 >= pr.y1) pr.cw = pr.ch = 0;
                    pr.cblks.resize((size_t)pr.cw * pr.ch);
                    for (int k = 0; k < pr.cw * pr.ch; ++k) {
                        Cblk& cb = pr.cblks[k];
                        int64_t bx = cx0 + (int64_t)(k % pr.cw) * ((int64_t)1 << cblkw);
                        int64_t by = cy0 + (int64_t)(k / pr.cw) * ((int64_t)1 << cblkh);
                        cb.x0 = (int)std::max(bx, pr.x0);
                        cb.y0 = (int)std::max(by, pr.y0);
                        cb.x1 = (int)std::min(bx + ((int64_t)1 << cblkw), pr.x1);
                        cb.y1 = (int)std::min(by + ((int64_t)1 << cblkh), pr.y1);
                    }
                    pr.incl.init(pr.cw, pr.ch);
                    pr.imsb.init(pr.cw, pr.ch);
                }
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Packet iterator (pi.c)
// ---------------------------------------------------------------------------

struct Packet {
    int layno, resno, compno, precno;
};

void packet_order(const Image& img, const TCP& tcp, const std::vector<TileComp>& tcs, const int64_t t[4],
                  std::vector<Packet>& out) {
    int ncomp = (int)img.comps.size();
    int maxres = 0, maxprec = 0;
    uint64_t dxmin = UINT32_MAX, dymin = UINT32_MAX;
    for (int c = 0; c < ncomp; ++c) {
        const TileComp& tc = tcs[c];
        maxres = std::max(maxres, tc.numres);
        for (int r = 0; r < tc.numres; ++r) {
            const Res& rs = tc.res[r];
            maxprec = std::max(maxprec, rs.pw * rs.ph);
            int level = tc.numres - 1 - r;
            if (rs.pdx + level < 32 && (uint64_t)img.comps[c].dx <= UINT32_MAX / (1u << (rs.pdx + level)))
                dxmin = std::min<uint64_t>(dxmin, (uint64_t)img.comps[c].dx << (rs.pdx + level));
            if (rs.pdy + level < 32 && (uint64_t)img.comps[c].dy <= UINT32_MAX / (1u << (rs.pdy + level)))
                dymin = std::min<uint64_t>(dymin, (uint64_t)img.comps[c].dy << (rs.pdy + level));
        }
    }
    int64_t step_p = 1, step_c = (int64_t)maxprec * step_p, step_r = ncomp * step_c, step_l = maxres * step_r;
    int64_t include_size = (int64_t)tcp.numlayers * step_l;
    if (include_size > ((int64_t)1 << 31)) fail();
    std::vector<uint8_t> include((size_t)include_size);
    std::vector<Poc> pocs = tcp.pocs;
    if (pocs.empty()) {
        if (tcp.prg < 0) fail();
        pocs.push_back(Poc{0, 0, tcp.numlayers, maxres, ncomp, tcp.prg});
    }
    uint64_t tx0 = (uint64_t)t[0], ty0 = (uint64_t)t[1], tx1 = (uint64_t)t[2], ty1 = (uint64_t)t[3];

    struct EndOfProgression {};  // opj_pi_next's "Invalid access to pi->include" ends the progression
    auto emit = [&](int l, int r, int c, int p) {
        int64_t index = l * step_l + r * step_r + c * step_c + p * step_p;
        if (index >= include_size) throw EndOfProgression{};
        if (!include[index]) {
            include[index] = 1;
            out.push_back(Packet{l, r, c, p});
        }
    };
    // the precinct of component c, resolution r holding position (x, y), or -1 (the B.12.1.3 tests)
    auto precinct_at = [&](int c, int r, uint64_t x, uint64_t y) -> int {
        const TileComp& tc = tcs[c];
        if (r >= tc.numres) return -1;
        const Res& rs = tc.res[r];
        uint64_t dx = img.comps[c].dx, dy = img.comps[c].dy;
        int levelno = tc.numres - 1 - r;
        if (levelno >= 32 || ((dx << levelno) >> levelno) != dx || ((dy << levelno) >> levelno) != dy) return -1;
        if ((dx << levelno) > INT32_MAX || (dy << levelno) > INT32_MAX) return -1;
        uint64_t trx0 = ceildiv((int64_t)tx0, (int64_t)(dx << levelno));
        uint64_t try0 = ceildiv((int64_t)ty0, (int64_t)(dy << levelno));
        uint64_t trx1 = ceildiv((int64_t)tx1, (int64_t)(dx << levelno));
        uint64_t try1 = ceildiv((int64_t)ty1, (int64_t)(dy << levelno));
        int rpx = rs.pdx + levelno, rpy = rs.pdy + levelno;
        if (rpx >= 31 || ((dx << rpx) >> rpx) != dx || rpy >= 31 || ((dy << rpy) >> rpy) != dy) return -1;
        if (!((y % (dy << rpy) == 0) || ((y == ty0) && ((try0 << levelno) % (1ull << rpy))))) return -1;
        if (!((x % (dx << rpx) == 0) || ((x == tx0) && ((trx0 << levelno) % (1ull << rpx))))) return -1;
        if (rs.pw == 0 || rs.ph == 0) return -1;
        if (trx0 == trx1 || try0 == try1) return -1;
        uint64_t prci = (ceildiv((int64_t)x, (int64_t)(dx << levelno)) >> rs.pdx) - (trx0 >> rs.pdx);
        uint64_t prcj = (ceildiv((int64_t)y, (int64_t)(dy << levelno)) >> rs.pdy) - (try0 >> rs.pdy);
        return (int)(prci + prcj * rs.pw);
    };

    for (const Poc& poc : pocs) {
        int lay1 = std::min(poc.lay1, tcp.numlayers);
        int res0 = poc.res0, res1 = poc.res1, comp0 = poc.comp0, comp1 = std::min(poc.comp1, ncomp);
        try {
        switch (poc.prg) {
        case 0:  // LRCP
            for (int l = 0; l < lay1; ++l)
                for (int r = res0; r < res1; ++r)
                    for (int c = comp0; c < comp1; ++c) {
                        if (r >= tcs[c].numres) continue;
                        const Res& rs = tcs[c].res[r];
                        for (int p = 0; p < rs.pw * rs.ph; ++p) emit(l, r, c, p);
                    }
            break;
        case 1:  // RLCP
            for (int r = res0; r < res1; ++r)
                for (int l = 0; l < lay1; ++l)
                    for (int c = comp0; c < comp1; ++c) {
                        if (r >= tcs[c].numres) continue;
                        const Res& rs = tcs[c].res[r];
                        for (int p = 0; p < rs.pw * rs.ph; ++p) emit(l, r, c, p);
                    }
            break;
        case 2:  // RPCL
            if (dxmin == 0 || dymin == 0 || dxmin == UINT32_MAX || dymin == UINT32_MAX) break;
            for (int r = res0; r < res1; ++r)
                for (uint64_t y = ty0; y < ty1; y += dymin - (y % dymin))
                    for (uint64_t x = tx0; x < tx1; x += dxmin - (x % dxmin))
                        for (int c = comp0; c < comp1; ++c) {
                            int p = precinct_at(c, r, x, y);
                            if (p < 0) continue;
                            for (int l = 0; l < lay1; ++l) emit(l, r, c, p);
                        }
            break;
        case 3:  // PCRL
            if (dxmin == 0 || dymin == 0 || dxmin == UINT32_MAX || dymin == UINT32_MAX) break;
            for (uint64_t y = ty0; y < ty1; y += dymin - (y % dymin))
                for (uint64_t x = tx0; x < tx1; x += dxmin - (x % dxmin))
                    for (int c = comp0; c < comp1; ++c)
                        for (int r = res0; r < res1; ++r) {
                            int p = precinct_at(c, r, x, y);
                            if (p < 0) continue;
                            for (int l = 0; l < lay1; ++l) emit(l, r, c, p);
                        }
            break;
        case 4:  // CPRL: the position steps of each component alone
            for (int c = comp0; c < comp1; ++c) {
                const TileComp& tc = tcs[c];
                uint64_t dx = 0, dy = 0;
                for (int r = 0; r < tc.numres; ++r) {
                    const Res& rs = tc.res[r];
                    int level = tc.numres - 1 - r;
                    if (rs.pdx + level < 32 && (uint64_t)img.comps[c].dx <= UINT32_MAX / (1u << (rs.pdx + level))) {
                        uint64_t d = (uint64_t)img.comps[c].dx << (rs.pdx + level);
                        dx = dx ? std::min(dx, d) : d;
                    }
                    if (rs.pdy + level < 32 && (uint64_t)img.comps[c].dy <= UINT32_MAX / (1u << (rs.pdy + level))) {
                        uint64_t d = (uint64_t)img.comps[c].dy << (rs.pdy + level);
                        dy = dy ? std::min(dy, d) : d;
                    }
                }
                if (dx == 0 || dy == 0) throw EndOfProgression{};
                for (uint64_t y = ty0; y < ty1; y += dy - (y % dy))
                    for (uint64_t x = tx0; x < tx1; x += dx - (x % dx))
                        for (int r = res0; r < std::min(res1, tc.numres); ++r) {
                            int p = precinct_at(c, r, x, y);
                            if (p < 0) continue;
                            for (int l = 0; l < lay1; ++l) emit(l, r, c, p);
                        }
            }
            break;
        default:  // an unknown order: no packet
            break;
        }
        } catch (const EndOfProgression&) {
        }
    }
}

// ---------------------------------------------------------------------------
// Packet headers and bodies (t2.c, bio.c, tgt.c)
// ---------------------------------------------------------------------------

struct Bio {
    const uint8_t *bp, *end, *start;
    uint32_t buf = 0, ct = 0;
    Bio(const uint8_t* p, size_t len) : bp(p), end(p + len), start(p) {}
    void bytein() {
        buf = (buf << 8) & 0xffff;
        ct = buf == 0xff00 ? 7 : 8;
        if (bp < end) buf |= *bp++;
    }
    uint32_t bit() {
        if (ct == 0) bytein();
        --ct;
        return (buf >> ct) & 1;
    }
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = n - 1; i >= 0; --i) v |= bit() << i;
        return v;
    }
    void inalign() {
        ct = 0;
        if ((buf & 0xff) == 0xff) bytein();
        ct = 0;
    }
    size_t numbytes() const { return (size_t)(bp - start); }
};

int tgt_decode(Bio& bio, TagTree& tree, int leaf, int threshold) {
    int stk[32], n = 0;
    int node = leaf;
    while (tree.nodes[node].parent >= 0) {
        stk[n++] = node;
        node = tree.nodes[node].parent;
    }
    int low = 0;
    for (;;) {
        TagTree::Node& nd = tree.nodes[node];
        if (low > nd.low) nd.low = low;
        else low = nd.low;
        while (low < threshold && low < nd.value) {
            if (bio.read(1)) nd.value = low;
            else ++low;
        }
        nd.low = low;
        if (n == 0) break;
        node = stk[--n];
    }
    return tree.nodes[node].value < threshold ? 1 : 0;
}

void init_seg(Cblk& cb, int segno, int cblksty, bool first) {
    if ((int)cb.segs.size() <= segno) cb.segs.resize(segno + 1);
    Seg& s = cb.segs[segno];
    s = Seg();
    if (cblksty & 4) {  // termination on every pass
        s.maxpasses = 1;
    } else if (cblksty & 1) {  // selective arithmetic bypass
        if (first) s.maxpasses = 10;
        else s.maxpasses = (cb.segs[segno - 1].maxpasses == 1 || cb.segs[segno - 1].maxpasses == 10) ? 2 : 1;
    } else {
        s.maxpasses = 109;
    }
}

int numpasses(Bio& bio) {
    if (!bio.read(1)) return 1;
    if (!bio.read(1)) return 2;
    int n = (int)bio.read(2);
    if (n != 3) return 3 + n;
    n = (int)bio.read(5);
    if (n != 31) return 6 + n;
    return 37 + (int)bio.read(7);
}

int floorlog2(uint32_t a) {
    int l = 0;
    while (a > 1) {
        a >>= 1;
        ++l;
    }
    return l;
}

// one packet: its header (from the tile data, or PPM / PPT) and its body; pos moves past what it read
void read_packet(Codestream& cs, TCP& tcp, std::vector<TileComp>& tcs, const Packet& pk, const uint8_t* src,
                 size_t len, size_t& pos, std::vector<uint8_t>* ppt, size_t& ppt_pos) {
    Res& rs = tcs[pk.compno].res[pk.resno];
    const TCCP& tc = tcp.tccps[pk.compno];
    // SOP: skipped where found, else (a warning) read on
    if (tcp.csty & 2) {
        if (len - pos >= 6 && src[pos] == 0xff && src[pos + 1] == 0x91) pos += 6;
    }
    const uint8_t* hdr;
    size_t hdr_len;
    size_t* hpos;
    if (cs.ppm) {
        hdr = cs.ppm_data.data() + cs.ppm_pos;
        hdr_len = cs.ppm_data.size() - cs.ppm_pos;
        hpos = &cs.ppm_pos;
    } else if (ppt) {
        hdr = ppt->data() + ppt_pos;
        hdr_len = ppt->size() - ppt_pos;
        hpos = &ppt_pos;
    } else {
        hdr = src + pos;
        hdr_len = len - pos;
        hpos = &pos;
    }
    Bio bio(hdr, hdr_len);
    bool present = bio.read(1);
    if (present) {
        for (int b = 0; b < rs.numbands; ++b) {
            Band& bd = rs.bands[b];
            if (bd.empty()) continue;
            Prc& pr = bd.prcs[pk.precno];
            for (int k = 0; k < pr.cw * pr.ch; ++k) {
                Cblk& cb = pr.cblks[k];
                int included;
                if (!cb.numsegs) included = tgt_decode(bio, pr.incl, k, pk.layno + 1);
                else included = (int)bio.read(1);
                if (!included) {
                    cb.numnewpasses = 0;
                    continue;
                }
                if (!cb.numsegs) {
                    int i = 0;
                    // a count past the band's bit-planes leaves the code-block empty, as in OpenJPEG; a tree
                    // that never ends (zeros past the header's end) would hang it, and fails here
                    while (!tgt_decode(bio, pr.imsb, k, i)) {
                        if (++i > (1 << 20)) fail();
                    }
                    cb.numbps = bd.numbps + 1 - i;
                    cb.numlenbits = 3;
                }
                cb.numnewpasses = numpasses(bio);
                int increment = 0;
                while (bio.read(1)) ++increment;
                cb.numlenbits += increment;
                int segno = 0;
                if (!cb.numsegs) {
                    init_seg(cb, 0, tc.cblksty, true);
                } else {
                    segno = cb.numsegs - 1;
                    if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                        ++segno;
                        init_seg(cb, segno, tc.cblksty, false);
                    }
                }
                int n = cb.numnewpasses;
                do {
                    Seg& s = cb.segs[segno];
                    s.numnewpasses = std::min(s.maxpasses - s.numpasses, n);
                    int bits = cb.numlenbits + floorlog2((uint32_t)s.numnewpasses);
                    if (bits > 32) fail();
                    s.newlen = (int)bio.read(bits);
                    n -= s.numnewpasses;
                    if (n > 0) {
                        ++segno;
                        init_seg(cb, segno, tc.cblksty, false);
                    }
                } while (n > 0);
            }
        }
    }
    bio.inalign();
    size_t used = bio.numbytes();
    // EPH: required where the coding style asks for it
    if (tcp.csty & 4) {
        if (hdr_len - used < 2 || hdr[used] != 0xff || hdr[used + 1] != 0x92) fail();
        used += 2;
    }
    *hpos += used;
    if (!present) return;
    // the body (opj_t2_read_packet_data): a segment past the tile-part's end fails in strict mode
    for (int b = 0; b < rs.numbands; ++b) {
        Band& bd = rs.bands[b];
        if (bd.empty()) continue;
        Prc& pr = bd.prcs[pk.precno];
        for (int k = 0; k < pr.cw * pr.ch; ++k) {
            Cblk& cb = pr.cblks[k];
            if (!cb.numnewpasses) continue;
            int segno;
            if (!cb.numsegs) {
                segno = 0;
                cb.numsegs = 1;
            } else {
                segno = cb.numsegs - 1;
                if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
                    ++segno;
                    ++cb.numsegs;
                }
            }
            do {
                Seg& s = cb.segs[segno];
                if ((size_t)s.newlen > len - pos) fail();  // "read: segment too long"
                cb.data.insert(cb.data.end(), src + pos, src + pos + s.newlen);
                pos += s.newlen;
                s.len += s.newlen;
                s.numpasses += s.numnewpasses;
                cb.numnewpasses -= s.numnewpasses;
                if (cb.numnewpasses > 0) {
                    ++segno;
                    ++cb.numsegs;
                }
            } while (cb.numnewpasses > 0);
        }
    }
}

// ---------------------------------------------------------------------------
// Tier-1: the MQ decoder (mqc.c) and the coding passes (t1.c)
// ---------------------------------------------------------------------------

const uint16_t kQe[47] = {
    0x5601, 0x3401, 0x1801, 0x0AC1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801, 0x3001, 0x2401,
    0x1C01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401, 0x3001, 0x2801, 0x2401, 0x2201,
    0x1C01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101, 0x0AC1, 0x09C1, 0x08A1, 0x0521, 0x0441, 0x02A1,
    0x0221, 0x0141, 0x0111, 0x0085, 0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};

struct Ctx {
    uint8_t state, mps;
};

struct MQ {
    const uint8_t* bp;
    uint32_t c, a, ct;
    Ctx ctx[19];
    void reset_states() {
        for (auto& x : ctx) x = Ctx{0, 0};
        ctx[18] = Ctx{46, 0};  // uniform
        ctx[17] = Ctx{3, 0};   // run length
        ctx[0] = Ctx{4, 0};    // zero coding, no significant neighbour
    }
    void bytein() {
        if (*bp == 0xff) {
            if (bp[1] > 0x8f) {
                c += 0xff00;
                ct = 8;
            } else {
                ++bp;
                c += (uint32_t)*bp << 9;
                ct = 7;
            }
        } else {
            ++bp;
            c += (uint32_t)*bp << 8;
            ct = 8;
        }
    }
    // buf holds the segment's bytes and two 0xff after them
    void init(const uint8_t* buf) {
        bp = buf;
        c = (uint32_t)*bp << 16;
        bytein();
        c <<= 7;
        ct -= 7;
        a = 0x8000;
    }
    void renorm() {
        do {
            if (ct == 0) bytein();
            a <<= 1;
            c <<= 1;
            --ct;
        } while (a < 0x8000);
    }
    int decode(int cx) {
        Ctx& x = ctx[cx];
        uint32_t qe = kQe[x.state];
        int d;
        a -= qe;
        if ((c >> 16) < qe) {
            if (a < qe) {
                a = qe;
                d = x.mps;
                x.state = kNmps[x.state];
            } else {
                a = qe;
                d = 1 - x.mps;
                if (x.state == 0 || x.state == 6 || x.state == 14) x.mps ^= 1;
                x.state = kNlps[x.state];
            }
            renorm();
        } else {
            c -= qe << 16;
            if ((a & 0x8000) == 0) {
                if (a < qe) {
                    d = 1 - x.mps;
                    if (x.state == 0 || x.state == 6 || x.state == 14) x.mps ^= 1;
                    x.state = kNlps[x.state];
                } else {
                    d = x.mps;
                    x.state = kNmps[x.state];
                }
                renorm();
            } else {
                d = x.mps;
            }
        }
        return d;
    }
    void raw_init(const uint8_t* buf) {
        bp = buf;
        c = 0;
        ct = 0;
    }
    int raw_decode() {
        if (ct == 0) {
            if (c == 0xff) {
                if (*bp > 0x8f) {
                    c = 0xff;
                    ct = 8;
                } else {
                    c = *bp++;
                    ct = 7;
                }
            } else {
                c = *bp++;
                ct = 8;
            }
        }
        --ct;
        return (int)((c >> ct) & 1);
    }
};

enum { kSig = 1, kNeg = 2, kVisit = 4, kRefined = 8 };

struct T1 {
    int w, h, stride;
    std::vector<uint8_t> f;  // per sample flags, with a border of one
    std::vector<int32_t> data;
    MQ mq;
    int orient, vsc;

    uint8_t& at(int y, int x) { return f[(size_t)(y + 1) * stride + x + 1]; }
    // the neighbour below is ignored in the last row of a stripe under the vertically causal context
    bool below_seen(int y) const { return !(vsc && (y & 3) == 3); }
    int sig(int y, int x) { return at(y, x) & kSig; }

    int zc_ctx(int y, int x) {
        int hs = sig(y, x - 1) + sig(y, x + 1);
        int vs = sig(y - 1, x);
        int ds = sig(y - 1, x - 1) + sig(y - 1, x + 1);
        if (below_seen(y)) {
            vs += sig(y + 1, x);
            ds += sig(y + 1, x - 1) + sig(y + 1, x + 1);
        }
        if (orient == 1) std::swap(hs, vs);  // HL: horizontal and vertical swap (Table D.1)
        if (orient == 3) {
            int hv = hs + vs;
            if (ds >= 3) return 8;
            if (ds == 2) return hv >= 1 ? 7 : 6;
            if (ds == 1) return hv >= 2 ? 5 : hv == 1 ? 4 : 3;
            return hv >= 2 ? 2 : hv == 1 ? 1 : 0;
        }
        if (hs == 2) return 8;
        if (hs == 1) return vs >= 1 ? 7 : ds >= 1 ? 6 : 5;
        if (vs == 2) return 4;
        if (vs == 1) return 3;
        return ds >= 2 ? 2 : ds == 1 ? 1 : 0;
    }
    bool any_neighbour(int y, int x) {
        int s = sig(y, x - 1) | sig(y, x + 1) | sig(y - 1, x - 1) | sig(y - 1, x) | sig(y - 1, x + 1);
        if (below_seen(y)) s |= sig(y + 1, x - 1) | sig(y + 1, x) | sig(y + 1, x + 1);
        return s != 0;
    }
    static int contrib(uint8_t v) { return (v & kSig) ? ((v & kNeg) ? -1 : 1) : 0; }
    int decode_sign(int y, int x) {
        int hc = contrib(at(y, x - 1)) + contrib(at(y, x + 1));
        int vc = contrib(at(y - 1, x)) + (below_seen(y) ? contrib(at(y + 1, x)) : 0);
        hc = std::max(-1, std::min(1, hc));
        vc = std::max(-1, std::min(1, vc));
        int ctx, xorbit;
        if (hc == 0) {
            ctx = vc == 0 ? 9 : 10;
            xorbit = vc < 0;
        } else {
            ctx = vc == 0 ? 12 : (vc == hc ? 13 : 11);
            xorbit = hc < 0;
        }
        return mq.decode(ctx) ^ xorbit;
    }
    void set_sig(int y, int x, int neg, int32_t oneplushalf) {
        data[(size_t)y * w + x] = neg ? -oneplushalf : oneplushalf;
        at(y, x) |= kSig | (neg ? kNeg : 0);
    }

    void sigpass(int bpno, bool raw) {
        int32_t one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    uint8_t& fl = at(y, x);
                    if (fl & (kSig | kVisit)) continue;
                    if (!any_neighbour(y, x)) continue;
                    if (raw) {
                        if (mq.raw_decode()) set_sig(y, x, mq.raw_decode(), oneplushalf);
                    } else if (mq.decode(zc_ctx(y, x))) {
                        set_sig(y, x, decode_sign(y, x), oneplushalf);
                    }
                    at(y, x) |= kVisit;
                }
    }
    void refpass(int bpno, bool raw) {
        int32_t poshalf = (1 << bpno) >> 1;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x)
                for (int y = k; y < std::min(k + 4, h); ++y) {
                    uint8_t& fl = at(y, x);
                    if ((fl & (kSig | kVisit)) != kSig) continue;
                    int v;
                    if (raw) {
                        v = mq.raw_decode();
                    } else {
                        int ctx = (fl & kRefined) ? 16 : any_neighbour(y, x) ? 15 : 14;
                        v = mq.decode(ctx);
                    }
                    int32_t& d = data[(size_t)y * w + x];
                    d += (v ^ (d < 0)) ? poshalf : -poshalf;
                    fl |= kRefined;
                }
    }
    void clnpass(int bpno, bool segsym) {
        int32_t one = 1 << bpno, half = one >> 1, oneplushalf = one | half;
        for (int k = 0; k < h; k += 4)
            for (int x = 0; x < w; ++x) {
                int y = k;
                if (k + 3 < h) {
                    bool run = true;
                    for (int j = k; j < k + 4 && run; ++j)
                        if ((at(j, x) & (kSig | kVisit)) || any_neighbour(j, x)) run = false;
                    if (run) {
                        if (!mq.decode(17)) continue;
                        int runlen = mq.decode(18);
                        runlen = (runlen << 1) | mq.decode(18);
                        y = k + runlen;
                        set_sig(y, x, decode_sign(y, x), oneplushalf);
                        ++y;
                        for (; y < k + 4; ++y)
                            if (mq.decode(zc_ctx(y, x))) set_sig(y, x, decode_sign(y, x), oneplushalf);
                        continue;
                    }
                }
                for (; y < std::min(k + 4, h); ++y) {
                    if (at(y, x) & (kSig | kVisit)) continue;
                    if (mq.decode(zc_ctx(y, x))) set_sig(y, x, decode_sign(y, x), oneplushalf);
                }
            }
        for (auto& v : f) v &= (uint8_t)~kVisit;
        if (segsym) {
            for (int i = 0; i < 4; ++i) mq.decode(18);
        }
    }

    // opj_t1_decode_cblk; false where OpenJPEG fails the code-block
    bool decode(Cblk& cb, int orient_, int roishift, int cblksty) {
        w = cb.x1 - cb.x0;
        h = cb.y1 - cb.y0;
        stride = w + 2;
        f.assign((size_t)(h + 2) * stride, 0);
        data.assign((size_t)w * h, 0);
        orient = orient_;
        vsc = (cblksty & 8) != 0;
        int bpno_plus_one = roishift + cb.numbps;
        if (bpno_plus_one >= 31) return false;
        int passtype = 2;
        mq.reset_states();
        std::vector<uint8_t> buf;
        size_t at_byte = 0;
        for (int segno = 0; segno < cb.numsegs; ++segno) {
            const Seg& s = cb.segs[segno];
            bool raw = bpno_plus_one <= cb.numbps - 4 && passtype < 2 && (cblksty & 1);
            buf.assign(cb.data.begin() + at_byte, cb.data.begin() + at_byte + s.len);
            buf.push_back(0xff);
            buf.push_back(0xff);
            at_byte += s.len;
            if (raw) mq.raw_init(buf.data());
            else mq.init(buf.data());
            for (int passno = 0; passno < s.numpasses && bpno_plus_one >= 1; ++passno) {
                if (passtype == 0) sigpass(bpno_plus_one, raw);
                else if (passtype == 1) refpass(bpno_plus_one, raw);
                else clnpass(bpno_plus_one, (cblksty & 32) != 0);
                if ((cblksty & 2) && !raw) mq.reset_states();
                if (++passtype == 3) {
                    passtype = 0;
                    --bpno_plus_one;
                }
            }
        }
        if (roishift) {
            int32_t thresh = 1 << roishift;
            for (auto& v : data) {
                int32_t mag = v < 0 ? -v : v;
                if (mag >= thresh) {
                    mag >>= roishift;
                    v = v < 0 ? -mag : mag;
                }
            }
        }
        return true;
    }
};

// ---------------------------------------------------------------------------
// Inverse wavelet transforms (dwt.c)
// ---------------------------------------------------------------------------

// the mirror of index k into [0, n) (periodic symmetric extension), n >= 2
inline int mirror(int k, int n) {
    while (k < 0 || k >= n) {
        if (k < 0) k = -k;
        if (k >= n) k = 2 * (n - 1) - k;
    }
    return k;
}

// one 1-D inverse 5/3 of n samples, the first of parity cas; x holds sn low then n - sn high coefficients
void idwt53_1d(int32_t* x, int n, int sn, int cas, std::vector<int32_t>& tmp) {
    if (n == 1) {
        if (cas) x[0] /= 2;
        return;
    }
    tmp.resize(n);
    // interleave: sample i (absolute parity i + cas) is low when even
    int li = 0, hi = sn;
    for (int i = 0; i < n; ++i) tmp[i] = (((i + cas) & 1) == 0) ? x[li++] : x[hi++];
    for (int i = 0; i < n; ++i)
        if (((i + cas) & 1) == 0) tmp[i] -= (tmp[mirror(i - 1, n)] + tmp[mirror(i + 1, n)] + 2) >> 2;
    for (int i = 0; i < n; ++i)
        if (((i + cas) & 1) == 1) tmp[i] += (tmp[mirror(i - 1, n)] + tmp[mirror(i + 1, n)]) >> 1;
    std::memcpy(x, tmp.data(), sizeof(int32_t) * n);
}

// one 1-D inverse 9/7 (opj_v8dwt_decode): scaling, then the four lifting steps, each
// target += (left + right) * c in float32, with symmetric extension
void idwt97_1d(float* x, int n, int sn, int cas, std::vector<float>& tmp) {
    const float kK = 1.230174105f, kTwoInvK = 1.625732422f;
    const float kAlpha = -1.586134342f, kBeta = -0.052980118f, kGamma = 0.882911075f, kDelta = 0.443506852f;
    int dn = n - sn;
    tmp.resize(n);
    int li = 0, hi = sn;
    for (int i = 0; i < n; ++i) tmp[i] = (((i + cas) & 1) == 0) ? x[li++] : x[hi++];
    bool skip = cas == 0 ? !(dn > 0 || sn > 1) : !(sn > 0 || dn > 1);
    if (!skip) {
        for (int i = 0; i < n; ++i) tmp[i] = tmp[i] * ((((i + cas) & 1) == 0) ? kK : kTwoInvK);
        const float cs[4] = {-kDelta, -kGamma, -kBeta, -kAlpha};
        for (int step = 0; step < 4; ++step) {
            int parity = step & 1;  // 0: the low samples, 1: the high ones
            float c = cs[step];
            for (int i = 0; i < n; ++i) {
                if (((i + cas) & 1) != parity) continue;
                float l = tmp[mirror(i - 1, n)], r = tmp[mirror(i + 1, n)];
                float s = l + r;
                float p = s * c;
                tmp[i] = tmp[i] + p;
            }
        }
    }
    std::memcpy(x, tmp.data(), sizeof(float) * n);
}

// the inverse transform of a tile-component up to its resolution nres - 1
template <typename T, typename F>
void idwt_2d(TileComp& tc, int nres, T* d, F one_d) {
    int64_t w = tc.x1 - tc.x0;
    std::vector<T> tmp, col;
    int64_t rw = tc.res[0].x1 - tc.res[0].x0, rh = tc.res[0].y1 - tc.res[0].y0;
    for (int r = 1; r < nres; ++r) {
        const Res& rs = tc.res[r];
        int64_t snh = rw, snv = rh;
        rw = rs.x1 - rs.x0;
        rh = rs.y1 - rs.y0;
        int cash = (int)(rs.x0 % 2), casv = (int)(rs.y0 % 2);
        if (rw > 0)
            for (int64_t j = 0; j < rh; ++j) one_d(d + j * w, (int)rw, (int)snh, cash, tmp);
        col.resize(rh);
        if (rh > 0)
            for (int64_t i = 0; i < rw; ++i) {
                for (int64_t j = 0; j < rh; ++j) col[j] = d[j * w + i];
                one_d(col.data(), (int)rh, (int)snv, casv, tmp);
                for (int64_t j = 0; j < rh; ++j) d[j * w + i] = col[j];
            }
    }
}

// ---------------------------------------------------------------------------
// One tile (opj_j2k_decode_tile, opj_tcd_decode_tile)
// ---------------------------------------------------------------------------

void decode_tile(Codestream& cs, int tileno, int32_t* out) {
    Image& img = cs.img;
    TCP& tcp = cs.tcps[tileno];
    std::vector<TileComp> tcs;
    int64_t t[4];
    init_tile(img, tcp, tileno, tcs, t);
    for (auto& tc : tcs) {
        int64_t n = (tc.x1 - tc.x0) * (tc.y1 - tc.y0);
        if (n > ((int64_t)1 << 31)) fail();
    }
    std::vector<Packet> order;
    packet_order(img, tcp, tcs, t, order);
    std::vector<uint8_t> ppt;
    bool has_ppt = !tcp.ppt.empty();
    for (auto& kv : tcp.ppt) ppt.insert(ppt.end(), kv.second.begin(), kv.second.end());
    size_t pos = 0, ppt_pos = 0;
    for (const Packet& pk : order) {
        read_packet(cs, tcp, tcs, pk, tcp.data.data(), tcp.data.size(), pos, has_ppt ? &ppt : nullptr, ppt_pos);
        cs.resno_decoded[pk.compno] = std::max(cs.resno_decoded[pk.compno], pk.resno);
    }
    T1 t1;
    for (size_t c = 0; c < tcs.size(); ++c) {
        TileComp& tc = tcs[c];
        const TCCP& tcc = tcp.tccps[c];
        int64_t w = tc.x1 - tc.x0, h = tc.y1 - tc.y0;
        bool rev = tcc.qmfbid == 1;
        if (rev) tc.idata.assign((size_t)(w * h), 0);
        else tc.fdata.assign((size_t)(w * h), 0.0f);
        for (int r = 0; r < tc.numres; ++r) {
            Res& rs = tc.res[r];
            for (int b = 0; b < rs.numbands; ++b) {
                Band& bd = rs.bands[b];
                if (bd.empty()) continue;
                int64_t ox = 0, oy = 0;
                if (bd.bandno & 1) ox = tc.res[r - 1].x1 - tc.res[r - 1].x0;
                if (bd.bandno & 2) oy = tc.res[r - 1].y1 - tc.res[r - 1].y0;
                float stepsize = 0.5f * bd.stepsize;
                for (Prc& pr : bd.prcs)
                    for (Cblk& cb : pr.cblks) {
                        if (!t1.decode(cb, bd.bandno, tcc.roishift, tcc.cblksty)) fail();
                        int64_t x = cb.x0 - bd.x0 + ox, y = cb.y0 - bd.y0 + oy;
                        for (int j = 0; j < t1.h; ++j)
                            for (int i = 0; i < t1.w; ++i) {
                                int32_t v = t1.data[(size_t)j * t1.w + i];
                                size_t at = (size_t)((y + j) * w + x + i);
                                if (rev) tc.idata[at] = v / 2;
                                else tc.fdata[at] = (float)v * stepsize;
                            }
                        std::vector<uint8_t>().swap(cb.data);
                    }
            }
        }
        // OpenJPEG reconstructs up to the highest resolution it read a packet for (resno_decoded)
        int nres = std::min(cs.resno_decoded[c], tc.numres - 1) + 1;
        if (rev) idwt_2d(tc, nres, tc.idata.data(), idwt53_1d);
        else idwt_2d(tc, nres, tc.fdata.data(), idwt97_1d);
    }
    // the component transform on the first three components (opj_tcd_mct_decode)
    if (tcp.mct == 1 && tcs.size() >= 3) {
        // "Tiles don't all have the same dimension": as many samples and resolutions read in all three
        int64_t n0 = (tcs[0].x1 - tcs[0].x0) * (tcs[0].y1 - tcs[0].y0);
        for (int c = 1; c < 3; ++c)
            if ((tcs[c].x1 - tcs[c].x0) * (tcs[c].y1 - tcs[c].y0) != n0 ||
                cs.resno_decoded[c] != cs.resno_decoded[0])
                fail();
        if (tcp.tccps[0].qmfbid == 1) {
            if (tcs[1].idata.empty() || tcs[2].idata.empty()) fail();
            for (int64_t i = 0; i < n0; ++i) {
                int32_t y = tcs[0].idata[i], u = tcs[1].idata[i], v = tcs[2].idata[i];
                int32_t g = y - ((u + v) >> 2);
                tcs[0].idata[i] = v + g;
                tcs[1].idata[i] = g;
                tcs[2].idata[i] = u + g;
            }
        } else {
            if (tcs[1].fdata.empty() || tcs[2].fdata.empty()) fail();
            for (int64_t i = 0; i < n0; ++i) {
                float y = tcs[0].fdata[i], u = tcs[1].fdata[i], v = tcs[2].fdata[i];
                float r = y + (v * 1.402f);
                float g = y - (u * 0.34413f) - (v * 0.71414f);
                float b = y + (u * 1.772f);
                tcs[0].fdata[i] = r;
                tcs[1].fdata[i] = g;
                tcs[2].fdata[i] = b;
            }
        }
    }
    // the DC level shift and clamp (opj_tcd_dc_level_shift_decode) of the resolution reconstructed, into the
    // image where opj_j2k_update_image_data places it
    int64_t offset = 0;
    for (size_t c = 0; c < tcs.size(); ++c) {
        const CompSiz& cz = img.comps[c];
        TileComp& tc = tcs[c];
        int64_t cx0 = ceildiv(img.x0, cz.dx), cy0 = ceildiv(img.y0, cz.dy);
        int64_t cw = ceildiv(img.x1, cz.dx) - cx0, ch = ceildiv(img.y1, cz.dy) - cy0;
        int64_t lo, hi, shift;
        if (cz.sgnd) {
            lo = -((int64_t)1 << (cz.prec - 1));
            hi = ((int64_t)1 << (cz.prec - 1)) - 1;
            shift = 0;
        } else {
            lo = 0;
            hi = ((int64_t)1 << cz.prec) - 1;
            shift = (int64_t)1 << (cz.prec - 1);
        }
        int64_t w = tc.x1 - tc.x0;
        bool rev = tcp.tccps[c].qmfbid == 1;
        const Res& rr = tc.res[std::min(cs.resno_decoded[c], tc.numres - 1)];
        // one axis of the placement: the start in the image, the offset in the tile, the extent
        auto place = [](int64_t d0, int64_t dlen, int64_t r0, int64_t r1, int64_t* start, int64_t* off,
                        int64_t* len) {
            int64_t d1 = d0 + dlen;
            if (d0 < r0) {
                *start = r0 - d0;
                *off = 0;
                *len = d1 >= r1 ? r1 - r0 : d1 - r0;
            } else {
                *start = 0;
                *off = d0 - r0;
                *len = d1 >= r1 ? r1 - r0 - *off : dlen;
            }
            if (*len < 0) fail();
        };
        int64_t sx, ox, nx, sy, oy, ny;
        place(cx0, cw, rr.x0, rr.x1, &sx, &ox, &nx);
        place(cy0, ch, rr.y0, rr.y1, &sy, &oy, &ny);
        for (int64_t j = 0; j < ny; ++j)
            for (int64_t i = 0; i < nx; ++i) {
                int64_t at = (oy + j) * w + ox + i, v;
                if (rev) {
                    v = (int64_t)tc.idata[at] + shift;
                } else {
                    float f = tc.fdata[at];
                    if (f > (float)INT32_MAX) v = hi;
                    else if (f < (float)INT32_MIN) v = lo;
                    else v = (int64_t)lrintf(f) + shift;
                }
                v = std::max(lo, std::min(hi, v));
                out[offset + (sy + j) * cw + sx + i] = (int32_t)v;
            }
        offset += cw * ch;
    }
}

// ---------------------------------------------------------------------------
// The codestream: tile-parts, then every tile
// ---------------------------------------------------------------------------

// whether a tile-part of tile `tileno` that follows `pos` (along the SOT chain, by Psot) is numbered as many
// as its TNsot says the tile has (tile-parts numbered up to TNsot, not below it), which OpenJPEG corrects
bool tiles_need_correction(const uint8_t* data, size_t size, size_t pos, int tileno) {
    auto be = [&](size_t at, int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; ++i) v = (v << 8) | data[at + i];
        return v;
    };
    for (;;) {
        if (size - pos < 2 || be(pos, 2) != 0xFF90) return false;
        if (size - pos < 4) fail();  // "Stream too short"
        if (be(pos + 2, 2) != 10) fail();  // "Inconsistent marker size"
        if (size - pos < 12) fail();
        int isot = (int)be(pos + 4, 2);
        uint32_t psot = be(pos + 6, 4);
        if (isot == tileno) return data[pos + 10] == data[pos + 11];
        if (psot < 14) return false;
        if (psot - 12 > size - pos - 12) return false;  // a skip past the end: all is assumed well
        pos += psot;
    }
}

int decode(const uint8_t* data, size_t size, int32_t* out, int64_t* meta, int64_t meta_size) {
    Codestream cs;
    Reader r(data, size);
    size_t sot = read_main_header(cs, r);  // the offset after the first SOT's marker code
    Image& img = cs.img;
    int64_t need = 5 + 4 * (int64_t)img.comps.size();
    if (meta_size < need) fail();
    meta[0] = (int64_t)img.comps.size();
    meta[1] = img.x1;
    meta[2] = img.y1;
    meta[3] = img.x0;
    meta[4] = img.y0;
    for (size_t c = 0; c < img.comps.size(); ++c) {
        meta[5 + 4 * c] = img.comps[c].prec;
        meta[6 + 4 * c] = img.comps[c].sgnd;
        meta[7 + 4 * c] = img.comps[c].dx;
        meta[8 + 4 * c] = img.comps[c].dy;
    }
    if (!out) return 1;
    if (cs.ppm) merge_ppm(cs);
    cs.tcps.assign((size_t)img.tw * img.th, cs.deflt);
    cs.resno_decoded.assign(img.comps.size(), 0);
    for (auto& tcp : cs.tcps) tcp.pocs = cs.deflt.pocs;
    r.pos = sot;
    // tile-parts as opj_j2k_read_tile_header reads them: a tile is decoded as soon as its last part (TNsot)
    // is read, and reading stops once every tile is, so that what follows is never looked at
    int ntiles = img.tw * img.th, decoded = 0, current = 0;
    std::vector<uint8_t> done((size_t)ntiles, 0);
    std::vector<int> last_part((size_t)ntiles, -1);
    // the first tile still to decode from `from` on (the "tiles with TPsot == 0 and TNsot == 0" of OpenJPEG)
    auto decode_pending = [&](int from, bool all) {
        for (int t = from; t < ntiles; ++t) {
            if (done[t] || !cs.tcps[t].seen) continue;
            decode_tile(cs, t, out);
            done[t] = 1;
            ++decoded;
            if (!all) break;
        }
    };
    int marker = 0xFF90;  // read by the main header's reader
    bool corrected = false, checked = false;
    for (;;) {
        if (marker == 0xFFD9) {  // at EOC OpenJPEG decodes the tiles still to decode from the first
            decode_pending(0, true);
            break;
        }
        if (r.left() == 0) {  // a marker that ends the stream: the first tile still to decode, then stop
            decode_pending(current, false);
            break;
        }
        size_t sot_at = r.pos - 2;
        if (r.left() < 10 || r.get(2) != 10) fail();  // "Error reading SOT marker"
        int isot = (int)r.get(2);
        uint32_t psot = r.get(4);
        int tpsot = (int)r.get(1);
        int tnsot = (int)r.get(1);
        if (isot >= ntiles) fail();
        TCP& tcp = cs.tcps[isot];
        if (tpsot != last_part[isot] + 1) fail();  // tile-parts come in order
        last_part[isot] = tpsot;
        if (psot != 0 && psot < 14) fail();
        if (tcp.nparts && tpsot >= tcp.nparts) fail();
        if (tnsot) {
            int nparts = tnsot + corrected;
            if (tcp.nparts && tpsot >= tcp.nparts) fail();
            if (tpsot >= nparts) fail();
            tcp.nparts = nparts;
        }
        current = isot;
        size_t part_end = psot ? sot_at + psot : size;
        bool ended = false;
        for (;;) {
            if (r.left() < 2) fail();
            int m = (int)r.get(2);
            if (m == 0xFF93) break;  // SOD
            if (r.left() == 0) {
                ended = true;
                break;
            }
            m = resolve_marker(r, m, kTileState);
            if (r.left() < 2) fail();
            size_t len = r.get(2);
            if (len < 2 || r.pos + len - 2 > size) fail();
            size_t end = r.pos + len - 2;
            if (end > part_end) fail();  // "Sot length is invalid"
            read_marker(cs, m, r, end, &tcp);
            r.pos = end;
        }
        if (ended) {  // the stream ends on a marker of the header: as at a marker that ends it above
            decode_pending(current, false);
            break;
        }
        // strict mode: a tile-part longer than the stream fails
        if (psot != 0 && sot_at + psot > size) fail();
        size_t data_end = psot ? part_end : (size >= 2 ? size - 2 : size);
        if (data_end < r.pos) data_end = r.pos;
        tcp.data.insert(tcp.data.end(), data + r.pos, data + data_end);
        tcp.seen = tcp.seen || data_end > r.pos;  // OpenJPEG keeps no data of an empty tile-part
        r.pos = data_end;
        if (tcp.nparts && tcp.nparts == tpsot + 1 && !checked) {
            // the first tile to be complete: unless it declares a single tile-part, OpenJPEG 2.5.3
            // (opj_j2k_need_nb_tile_parts_correction) looks ahead along the tile-parts for another of this tile
            // numbered TNsot, and counts one part more in every tile if there is one
            checked = true;
            if (tcp.nparts > 1 && tiles_need_correction(data, size, r.pos, isot)) {
                corrected = true;
                for (auto& t : cs.tcps)
                    if (t.nparts) ++t.nparts;
            }
        }
        bool complete = tcp.nparts && tcp.nparts == tpsot + 1 && !done[isot];
        if (r.left() < 2 && !complete) {
            // "non conformant SPOT6 files": the stream ends after the last tile's part, and a tile read as
            // TPsot 0 of TNsot 0 is taken for the first of those to decode at an EOC
            int first = -1;
            if (isot + 1 == ntiles)
                for (int t = 0; t < ntiles && first < 0; ++t)
                    if (last_part[t] == 0 && cs.tcps[t].nparts == 0) first = t;
            if (first < 0) fail();  // "Stream too short"
            decode_pending(first, true);
            break;
        }
        if (r.left() < 2) fail();  // "Stream too short"
        if (complete) {
            if (!tcp.seen) fail();  // a tile of no data fails opj_j2k_decode_tile
            decode_tile(cs, isot, out);
            done[isot] = 1;
            ++decoded;
            // opj_j2k_decode_tile then reads the next marker, which must be SOT or EOC, or else the last two
            // bytes of the stream ("Stream does not end with EOC"), where decoding stops
            marker = (int)r.get(2);
            if (marker != 0xFF90 && marker != 0xFFD9) {
                if (r.left() == 0) return 0;
                fail();
            }
            if (decoded == ntiles) return 0;
            continue;
        }
        marker = (int)r.get(2);
        if (marker == 0xFFD9) continue;
        if (r.left() == 0) {  // the last two bytes, not EOC: the first tile still to decode, then stop
            decode_pending(current, false);
            break;
        }
        marker = resolve_marker(r, marker, kSotState);
    }
    if (!decoded) fail();
    return 0;
}

}  // namespace

extern "C" {

// a codestream (from SOC) -> status; see the head of this file
int j2k_decode(const uint8_t* data, int64_t size, int32_t* out, int64_t out_size, int64_t* meta,
               int64_t meta_size) {
    (void)out_size;
    try {
        return decode(data, (size_t)size, out, meta, meta_size);
    } catch (const Fail& f) {
        return f.status;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
