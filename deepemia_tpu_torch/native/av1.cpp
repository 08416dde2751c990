// A decoder of the AV1 still pictures that libaom writes, as libavif hands
// them to libaom (AV1 specification, 2019 with errata): the OBU layer
// (sequence headers, full and reduced; temporal delimiter, frame, frame
// header and tile group OBUs; padding and metadata skipped), the
// uncompressed header of a shown key frame, tile info (uniform and not),
// segmentation (7.12.2: a quantizer, a lossless flag and loop filter levels
// per segment, the segment id of each block spatially predicted), the
// symbol decoder with CDF adaptation, partitions of 64x64 and 128x128
// superblocks down to 4x4, intra mode info (the segment id, skip, the CDEF
// index and delta q of a superblock, Y mode, angle delta, UV mode with CFL,
// palette mode with its colour cache and colour index maps, filter intra, the
// transform depth), coefficients of every transform size from 4x4 to
// 64x64 at the frame's q-context with their transform types (the
// intra and inter sets), dequantization with quantizer matrices, the inverse
// DCT, ADST, flipped ADST, identity and (lossless) Walsh-Hadamard transforms,
// and intra prediction at every transform size (DC, V, H, the directional
// modes with the edge filter and upsampling, smooth, Paeth, CFL, recursive
// filter intra, palette), at 8, 10 and 12 bits in 4:4:4, 4:2:2, 4:2:0 or
// 4:0:0, and the three in-loop filters: deblocking (7.14, with delta loop
// filter levels and segmentation's: a level per block), CDEF (7.15) and loop
// restoration (7.17: Wiener and self-guided units, switchable or not).
// Both screen content tools are decoded: palette mode, and intra block copy
// (a block vector from the spatial DV stack, coded against MV_INTRABC_CONTEXT
// and held to libaom's validity rules; the block copied from the frame's
// unfiltered reconstruction, chroma bilinear at half pixels; the variable
// transform partitioning and the inter transform types of its residual).
// A stream that uses a tool this decoder lacks is refused with the tool's
// number (kTool*); none is decoded wrong.
//
// Where libaom fails on a damaged stream, so does this decoder: a tile
// whose symbols run past its data at the end of a superblock
// (aom_reader_has_overflowed), a Golomb code longer than 20 bits, an OBU
// larger than its data, a sequence or frame header whose trailing bits are
// not a one and zeros, a partition whose chroma block the subsampling does
// not allow, a block vector libaom's av1_is_dv_valid rejects.
//
// The specification's larger tables (quantizer lookups and matrices, the
// coefficient, transform type and depth CDFs, scans, smooth weights) are in
// av1_tables.h, generated from libaom by tools/extract_av1_tables.py.
//
// Built by ``native/__init__.py`` with g++ at first use; the entry point is
// av1_decode.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

#include "av1_tables.h"

namespace {

int floor_log2(uint32_t x) { return x > 1 ? 31 - __builtin_clz(x) : 0; }

// The default CDFs of the AV1 specification (section 9.4) of the mode info, in
// the specification's form: N cumulative values ending in
// 32768, then the adaptation counter.
static const uint16_t kPartition8[4][5] = {
  {19132, 25510, 30392, 32768, 0},
  {13928, 19855, 28540, 32768, 0},
  {12522, 23679, 28629, 32768, 0},
  {9896, 18783, 25853, 32768, 0}};
static const uint16_t kPartition16[12][11] = {
  {15597, 20929, 24571, 26706, 27664, 28821, 29601, 30571, 31902, 32768, 0},
  {7925, 11043, 16785, 22470, 23971, 25043, 26651, 28701, 29834, 32768, 0},
  {5414, 13269, 15111, 20488, 22360, 24500, 25537, 26336, 32117, 32768, 0},
  {2662, 6362, 8614, 20860, 23053, 24778, 26436, 27829, 31171, 32768, 0},
  {18462, 20920, 23124, 27647, 28227, 29049, 29519, 30178, 31544, 32768, 0},
  {7689, 9060, 12056, 24992, 25660, 26182, 26951, 28041, 29052, 32768, 0},
  {6015, 9009, 10062, 24544, 25409, 26545, 27071, 27526, 32047, 32768, 0},
  {1394, 2208, 2796, 28614, 29061, 29466, 29840, 30185, 31899, 32768, 0},
  {20137, 21547, 23078, 29566, 29837, 30261, 30524, 30892, 31724, 32768, 0},
  {6732, 7490, 9497, 27944, 28250, 28515, 28969, 29630, 30104, 32768, 0},
  {5945, 7663, 8348, 28683, 29117, 29749, 30064, 30298, 32238, 32768, 0},
  {870, 1212, 1487, 31198, 31394, 31574, 31743, 31881, 32332, 32768, 0}};
static const uint16_t kPartition128[4][9] = {
  {27899, 28219, 28529, 32484, 32539, 32619, 32639, 32768, 0},
  {6607, 6990, 8268, 32060, 32219, 32338, 32371, 32768, 0},
  {5429, 6676, 7122, 32027, 32227, 32531, 32582, 32768, 0},
  {711, 966, 1172, 32448, 32538, 32617, 32664, 32768, 0}};
static const uint16_t kKfYMode[25][14] = {
  {15588, 17027, 19338, 20218, 20682, 21110, 21825, 23244, 24189, 28165, 29093, 30466, 32768, 0},
  {12016, 18066, 19516, 20303, 20719, 21444, 21888, 23032, 24434, 28658, 30172, 31409, 32768, 0},
  {10052, 10771, 22296, 22788, 23055, 23239, 24133, 25620, 26160, 29336, 29929, 31567, 32768, 0},
  {14091, 15406, 16442, 18808, 19136, 19546, 19998, 22096, 24746, 29585, 30958, 32462, 32768, 0},
  {12122, 13265, 15603, 16501, 18609, 20033, 22391, 25583, 26437, 30261, 31073, 32475, 32768, 0},
  {10023, 19585, 20848, 21440, 21832, 22760, 23089, 24023, 25381, 29014, 30482, 31436, 32768, 0},
  {5983, 24099, 24560, 24886, 25066, 25795, 25913, 26423, 27610, 29905, 31276, 31794, 32768, 0},
  {7444, 12781, 20177, 20728, 21077, 21607, 22170, 23405, 24469, 27915, 29090, 30492, 32768, 0},
  {8537, 14689, 15432, 17087, 17408, 18172, 18408, 19825, 24649, 29153, 31096, 32210, 32768, 0},
  {7543, 14231, 15496, 16195, 17905, 20717, 21984, 24516, 26001, 29675, 30981, 31994, 32768, 0},
  {12613, 13591, 21383, 22004, 22312, 22577, 23401, 25055, 25729, 29538, 30305, 32077, 32768, 0},
  {9687, 13470, 18506, 19230, 19604, 20147, 20695, 22062, 23219, 27743, 29211, 30907, 32768, 0},
  {6183, 6505, 26024, 26252, 26366, 26434, 27082, 28354, 28555, 30467, 30794, 32086, 32768, 0},
  {10718, 11734, 14954, 17224, 17565, 17924, 18561, 21523, 23878, 28975, 30287, 32252, 32768, 0},
  {9194, 9858, 16501, 17263, 18424, 19171, 21563, 25961, 26561, 30072, 30737, 32463, 32768, 0},
  {12602, 14399, 15488, 18381, 18778, 19315, 19724, 21419, 25060, 29696, 30917, 32409, 32768, 0},
  {8203, 13821, 14524, 17105, 17439, 18131, 18404, 19468, 25225, 29485, 31158, 32342, 32768, 0},
  {8451, 9731, 15004, 17643, 18012, 18425, 19070, 21538, 24605, 29118, 30078, 32018, 32768, 0},
  {7714, 9048, 9516, 16667, 16817, 16994, 17153, 18767, 26743, 30389, 31536, 32528, 32768, 0},
  {8843, 10280, 11496, 15317, 16652, 17943, 19108, 22718, 25769, 29953, 30983, 32485, 32768, 0},
  {12578, 13671, 15979, 16834, 19075, 20913, 22989, 25449, 26219, 30214, 31150, 32477, 32768, 0},
  {9563, 13626, 15080, 15892, 17756, 20863, 22207, 24236, 25380, 29653, 31143, 32277, 32768, 0},
  {8356, 8901, 17616, 18256, 19350, 20106, 22598, 25947, 26466, 29900, 30523, 32261, 32768, 0},
  {10835, 11815, 13124, 16042, 17018, 18039, 18947, 22753, 24615, 29489, 30883, 32482, 32768, 0},
  {7618, 8288, 9859, 10509, 15386, 18657, 22903, 28776, 29180, 31355, 31802, 32593, 32768, 0}};
static const uint16_t kUvModeNoCfl[13][14] = {
  {22631, 24152, 25378, 25661, 25986, 26520, 27055, 27923, 28244, 30059, 30941, 31961, 32768, 0},
  {9513, 26881, 26973, 27046, 27118, 27664, 27739, 27824, 28359, 29505, 29800, 31796, 32768, 0},
  {9845, 9915, 28663, 28704, 28757, 28780, 29198, 29822, 29854, 30764, 31777, 32029, 32768, 0},
  {13639, 13897, 14171, 25331, 25606, 25727, 25953, 27148, 28577, 30612, 31355, 32493, 32768, 0},
  {9764, 9835, 9930, 9954, 25386, 27053, 27958, 28148, 28243, 31101, 31744, 32363, 32768, 0},
  {11825, 13589, 13677, 13720, 15048, 29213, 29301, 29458, 29711, 31161, 31441, 32550, 32768, 0},
  {14175, 14399, 16608, 16821, 17718, 17775, 28551, 30200, 30245, 31837, 32342, 32667, 32768, 0},
  {12885, 13038, 14978, 15590, 15673, 15748, 16176, 29128, 29267, 30643, 31961, 32461, 32768, 0},
  {12026, 13661, 13874, 15305, 15490, 15726, 15995, 16273, 28443, 30388, 30767, 32416, 32768, 0},
  {19052, 19840, 20579, 20916, 21150, 21467, 21885, 22719, 23174, 28861, 30379, 32175, 32768, 0},
  {18627, 19649, 20974, 21219, 21492, 21816, 22199, 23119, 23527, 27053, 31397, 32148, 32768, 0},
  {17026, 19004, 19997, 20339, 20586, 21103, 21349, 21907, 22482, 25896, 26541, 31819, 32768, 0},
  {12124, 13759, 14959, 14992, 15007, 15051, 15078, 15166, 15255, 15753, 16039, 16606, 32768, 0}};
static const uint16_t kUvModeCfl[13][15] = {
  {10407, 11208, 12900, 13181, 13823, 14175, 14899, 15656, 15986, 20086, 20995, 22455, 24212, 32768, 0},
  {4532, 19780, 20057, 20215, 20428, 21071, 21199, 21451, 22099, 24228, 24693, 27032, 29472, 32768, 0},
  {5273, 5379, 20177, 20270, 20385, 20439, 20949, 21695, 21774, 23138, 24256, 24703, 26679, 32768, 0},
  {6740, 7167, 7662, 14152, 14536, 14785, 15034, 16741, 18371, 21520, 22206, 23389, 24182, 32768, 0},
  {4987, 5368, 5928, 6068, 19114, 20315, 21857, 22253, 22411, 24911, 25380, 26027, 26376, 32768, 0},
  {5370, 6889, 7247, 7393, 9498, 21114, 21402, 21753, 21981, 24780, 25386, 26517, 27176, 32768, 0},
  {4816, 4961, 7204, 7326, 8765, 8930, 20169, 20682, 20803, 23188, 23763, 24455, 24940, 32768, 0},
  {6608, 6740, 8529, 9049, 9257, 9356, 9735, 18827, 19059, 22336, 23204, 23964, 24793, 32768, 0},
  {5998, 7419, 7781, 8933, 9255, 9549, 9753, 10417, 18898, 22494, 23139, 24764, 25989, 32768, 0},
  {10660, 11298, 12550, 12957, 13322, 13624, 14040, 15004, 15534, 20714, 21789, 23443, 24861, 32768, 0},
  {10522, 11530, 12552, 12963, 13378, 13779, 14245, 15235, 15902, 20102, 22696, 23774, 25838, 32768, 0},
  {10099, 10691, 12639, 13049, 13386, 13665, 14125, 15163, 15636, 19676, 20474, 23519, 25208, 32768, 0},
  {3144, 5087, 7382, 7504, 7593, 7690, 7801, 8064, 8232, 9248, 9875, 10521, 29048, 32768, 0}};
static const uint16_t kAngleDelta[8][8] = {
  {2180, 5032, 7567, 22776, 26989, 30217, 32768, 0},
  {2301, 5608, 8801, 23487, 26974, 30330, 32768, 0},
  {3780, 11018, 13699, 19354, 23083, 31286, 32768, 0},
  {4581, 11226, 15147, 17138, 21834, 28397, 32768, 0},
  {1737, 10927, 14509, 19588, 22745, 28823, 32768, 0},
  {2664, 10176, 12485, 17650, 21600, 30495, 32768, 0},
  {2240, 11096, 15453, 20341, 22561, 28917, 32768, 0},
  {3605, 10428, 12459, 17676, 21244, 30655, 32768, 0}};
static const uint16_t kSkip[3][3] = {
  {31671, 32768, 0},
  {16515, 32768, 0},
  {4576, 32768, 0}};
static const uint16_t kFilterIntra[22][3] = {
  {4621, 32768, 0},
  {6743, 32768, 0},
  {5893, 32768, 0},
  {7866, 32768, 0},
  {12551, 32768, 0},
  {9394, 32768, 0},
  {12408, 32768, 0},
  {14301, 32768, 0},
  {12756, 32768, 0},
  {22343, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {12770, 32768, 0},
  {10368, 32768, 0},
  {20229, 32768, 0},
  {18101, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0}};
static const uint16_t kFilterIntraMode[6] = {8949, 12776, 17211, 29558, 32768, 0};
static const uint16_t kCflSign[9] = {1418, 2123, 13340, 18405, 26972, 28343, 32294, 32768, 0};
static const uint16_t kCflAlpha[6][17] = {
  {7637, 20719, 31401, 32481, 32657, 32688, 32692, 32696, 32700, 32704, 32708, 32712, 32716, 32720, 32724, 32768, 0},
  {14365, 23603, 28135, 31168, 32167, 32395, 32487, 32573, 32620, 32647, 32668, 32672, 32676, 32680, 32684, 32768, 0},
  {11532, 22380, 28445, 31360, 32349, 32523, 32584, 32649, 32673, 32677, 32681, 32685, 32689, 32693, 32697, 32768, 0},
  {26990, 31402, 32282, 32571, 32692, 32696, 32700, 32704, 32708, 32712, 32716, 32720, 32724, 32728, 32732, 32768, 0},
  {17248, 26058, 28904, 30608, 31305, 31877, 32126, 32321, 32394, 32464, 32516, 32560, 32576, 32593, 32622, 32768, 0},
  {14738, 21678, 25779, 27901, 29024, 30302, 30980, 31843, 32144, 32413, 32520, 32594, 32622, 32656, 32660, 32768, 0}};
static const int16_t kDrIntraDerivative[90] = {
    0, 0, 0, 1023, 0, 0, 547, 0, 0, 372, 0, 0, 0, 0, 273, 0, 0, 215, 0, 0, 178, 0, 0, 151, 0, 0, 132, 0, 0, 116,
    0, 0, 102, 0, 0, 0, 90, 0, 0, 80, 0, 0, 71, 0, 0, 64, 0, 0, 57, 0, 0, 51, 0, 0, 45, 0, 0, 0, 40, 0,
    0, 35, 0, 0, 31, 0, 0, 27, 0, 0, 23, 0, 0, 19, 0, 0, 15, 0, 0, 0, 0, 11, 0, 0, 7, 0, 0, 3, 0, 0};
static const int8_t kFilterIntraTaps[5][8][7] = {
    {{-6, 10, 0, 0, 0, 12, 0}, {-5, 2, 10, 0, 0, 9, 0}, {-3, 1, 1, 10, 0, 7, 0}, {-3, 1, 1, 2, 10, 5, 0},
     {-4, 6, 0, 0, 0, 2, 12}, {-3, 2, 6, 0, 0, 2, 9}, {-3, 2, 2, 6, 0, 2, 7}, {-3, 1, 2, 2, 6, 3, 5}},
    {{-10, 16, 0, 0, 0, 10, 0}, {-6, 0, 16, 0, 0, 6, 0}, {-4, 0, 0, 16, 0, 4, 0}, {-2, 0, 0, 0, 16, 2, 0},
     {-10, 16, 0, 0, 0, 0, 10}, {-6, 0, 16, 0, 0, 0, 6}, {-4, 0, 0, 16, 0, 0, 4}, {-2, 0, 0, 0, 16, 0, 2}},
    {{-8, 8, 0, 0, 0, 16, 0}, {-8, 0, 8, 0, 0, 16, 0}, {-8, 0, 0, 8, 0, 16, 0}, {-8, 0, 0, 0, 8, 16, 0},
     {-4, 4, 0, 0, 0, 0, 16}, {-4, 0, 4, 0, 0, 0, 16}, {-4, 0, 0, 4, 0, 0, 16}, {-4, 0, 0, 0, 4, 0, 16}},
    {{-2, 8, 0, 0, 0, 10, 0}, {-1, 3, 8, 0, 0, 6, 0}, {-1, 2, 3, 8, 0, 4, 0}, {0, 1, 2, 3, 8, 2, 0},
     {-1, 4, 0, 0, 0, 3, 10}, {-1, 3, 4, 0, 0, 4, 6}, {-1, 2, 3, 4, 0, 4, 4}, {-1, 2, 2, 3, 4, 3, 3}},
    {{-12, 14, 0, 0, 0, 14, 0}, {-10, 0, 14, 0, 0, 12, 0}, {-9, 0, 0, 14, 0, 11, 0}, {-8, 0, 0, 0, 14, 10, 0},
     {-10, 12, 0, 0, 0, 0, 14}, {-9, 1, 12, 0, 0, 0, 12}, {-8, 0, 0, 12, 0, 1, 11}, {-7, 0, 0, 1, 12, 1, 9}}};
static const int kModeToAngle[13] = {0, 90, 180, 45, 135, 113, 157, 203, 67, 0, 0, 0, 0};
static const int kIntraModeContext[13] = {0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0};
static const int kEdgeKernel[3][5] = {{0, 4, 8, 4, 0}, {0, 5, 6, 5, 0}, {2, 4, 4, 4, 2}};

// block sizes, in the specification's order
enum { B4X4, B4X8, B8X4, B8X8, B8X16, B16X8, B16X16, B16X32, B32X16, B32X32, B32X64, B64X32, B64X64,
       B64X128, B128X64, B128X128, B4X16, B16X4, B8X32, B32X8, B16X64, B64X16, BLOCK_INVALID };
static const int kWide4[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
static const int kHigh4[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
// Subsampled_Size[block][subsampling x][subsampling y]
static const uint8_t kSubsampled[22][2][2] = {
    {{B4X4, B4X4}, {B4X4, B4X4}}, {{B4X8, B4X4}, {BLOCK_INVALID, B4X4}}, {{B8X4, BLOCK_INVALID}, {B4X4, B4X4}},
    {{B8X8, B8X4}, {B4X8, B4X4}}, {{B8X16, B8X8}, {BLOCK_INVALID, B4X8}}, {{B16X8, BLOCK_INVALID}, {B8X8, B8X4}},
    {{B16X16, B16X8}, {B8X16, B8X8}}, {{B16X32, B16X16}, {BLOCK_INVALID, B8X16}},
    {{B32X16, BLOCK_INVALID}, {B16X16, B16X8}}, {{B32X32, B32X16}, {B16X32, B16X16}},
    {{B32X64, B32X32}, {BLOCK_INVALID, B16X32}}, {{B64X32, BLOCK_INVALID}, {B32X32, B32X16}},
    {{B64X64, B64X32}, {B32X64, B32X32}}, {{B64X128, B64X64}, {BLOCK_INVALID, B32X64}},
    {{B128X64, BLOCK_INVALID}, {B64X64, B64X32}}, {{B128X128, B128X64}, {B64X128, B64X64}},
    {{B4X16, B4X8}, {BLOCK_INVALID, B4X8}}, {{B16X4, BLOCK_INVALID}, {B8X4, B8X4}},
    {{B8X32, B8X16}, {BLOCK_INVALID, B4X16}}, {{B32X8, BLOCK_INVALID}, {B16X8, B16X4}},
    {{B16X64, B16X32}, {BLOCK_INVALID, B8X32}}, {{B64X16, BLOCK_INVALID}, {B32X16, B32X8}}};
enum { P_NONE, P_HORZ, P_VERT, P_SPLIT, P_HORZ_A, P_HORZ_B, P_VERT_A, P_VERT_B, P_HORZ_4, P_VERT_4 };
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED, SMOOTH_PRED,
       SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };

// transform sizes, in the specification's order
enum { TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64, TX_4X8, TX_8X4, TX_8X16, TX_16X8, TX_16X32, TX_32X16,
       TX_32X64, TX_64X32, TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16 };
static const int kTxWLog2[19] = {2, 3, 4, 5, 6, 2, 3, 3, 4, 4, 5, 5, 6, 2, 4, 3, 5, 4, 6};
static const int kTxHLog2[19] = {2, 3, 4, 5, 6, 3, 2, 4, 3, 5, 4, 6, 5, 4, 2, 5, 3, 6, 4};
static const int kTxRowShift[19] = {0, 1, 2, 2, 2, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2};
static const int kSplitTx[19] = {TX_4X4, TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_4X4, TX_4X4, TX_8X8, TX_8X8,
                                 TX_16X16, TX_16X16, TX_32X32, TX_32X32, TX_4X8, TX_8X4, TX_8X16, TX_16X8,
                                 TX_16X32, TX_32X16};
static const int kMaxTxRect[22] = {TX_4X4, TX_4X8, TX_8X4, TX_8X8, TX_8X16, TX_16X8, TX_16X16, TX_16X32,
                                   TX_32X16, TX_32X32, TX_32X64, TX_64X32, TX_64X64, TX_64X64, TX_64X64, TX_64X64,
                                   TX_4X16, TX_16X4, TX_8X32, TX_32X8, TX_16X64, TX_64X16};
static const int kMaxTxDepth[22] = {0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4, 4, 4, 4, 4, 2, 2, 3, 3, 4, 4};
// transform types (the intra sets use the first four, IDTX, V_DCT and H_DCT; the inter sets all 16)
enum { DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, FLIPADST_DCT, DCT_FLIPADST, FLIPADST_FLIPADST, ADST_FLIPADST,
       FLIPADST_ADST, IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST };
static const int kModeToTxfm[14] = {DCT_DCT, ADST_DCT, DCT_ADST, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST,
                                    DCT_ADST, ADST_DCT, ADST_ADST, ADST_DCT, DCT_ADST, ADST_ADST, DCT_DCT};
static const int kTxTypeIntraInvSet1[7] = {IDTX, DCT_DCT, V_DCT, H_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
static const int kTxTypeIntraInvSet2[5] = {IDTX, DCT_DCT, ADST_ADST, ADST_DCT, DCT_ADST};
static const int kTxTypeInterInvSet1[16] = {IDTX, V_DCT, H_DCT, V_ADST, H_ADST, V_FLIPADST, H_FLIPADST, DCT_DCT,
                                            ADST_DCT, DCT_ADST, FLIPADST_DCT, DCT_FLIPADST, ADST_ADST,
                                            FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
static const int kTxTypeInterInvSet2[12] = {IDTX, V_DCT, H_DCT, DCT_DCT, ADST_DCT, DCT_ADST, FLIPADST_DCT,
                                            DCT_FLIPADST, ADST_ADST, FLIPADST_FLIPADST, ADST_FLIPADST, FLIPADST_ADST};
static const int kFilterIntraModeToIntraDir[5] = {DC_PRED, V_PRED, H_PRED, D157_PRED, DC_PRED};
enum { TX_SET_DCTONLY, TX_SET_INTRA_1, TX_SET_INTRA_2, TX_SET_INTER_1, TX_SET_INTER_2, TX_SET_INTER_3 };
enum { kRestoreNone, kRestoreWiener, kRestoreSgrproj, kRestoreSwitchable };  // the specification's FrameRestorationType
enum { TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT };
static const int kSigRefDiffOffset[3][5][2] = {{{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}},
                                              {{0, 1}, {1, 0}, {0, 2}, {0, 3}, {0, 4}},
                                              {{0, 1}, {1, 0}, {2, 0}, {3, 0}, {4, 0}}};
static const int kMagRefOffset[3][3][2] = {{{0, 1}, {1, 0}, {1, 1}}, {{0, 1}, {1, 0}, {0, 2}},
                                          {{0, 1}, {1, 0}, {2, 0}}};
// Coeff_Base_Ctx_Offset by the shape of the transform: square, wide, tall
static const int kCoeffBaseCtxOffset[3][5][5] = {
    {{0, 1, 6, 6, 21}, {1, 6, 6, 21, 21}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}},
    {{0, 16, 6, 6, 21}, {16, 16, 6, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}, {16, 16, 21, 21, 21}},
    {{0, 11, 11, 11, 11}, {11, 11, 11, 11, 11}, {6, 6, 21, 21, 21}, {6, 21, 21, 21, 21}, {21, 21, 21, 21, 21}}};

int tx_w(int t) { return 1 << kTxWLog2[t]; }
int tx_h(int t) { return 1 << kTxHLog2[t]; }
int tx_sqr(int t) { return std::min(kTxWLog2[t], kTxHLog2[t]) - 2; }     // Tx_Size_Sqr, as TX_4X4 .. TX_64X64
int tx_sqr_up(int t) { return std::max(kTxWLog2[t], kTxHLog2[t]) - 2; }  // Tx_Size_Sqr_Up

// the default, mrow and mcol scans of the coded (at most 32x32) part of a transform
const int16_t* default_scan(int w, int h) {
  using namespace av1t;
  switch (w * 100 + h) {
    case 404: return kDefaultScan4x4;
    case 808: return kDefaultScan8x8;
    case 1616: return kDefaultScan16x16;
    case 3232: return kDefaultScan32x32;
    case 408: return kDefaultScan4x8;
    case 804: return kDefaultScan8x4;
    case 816: return kDefaultScan8x16;
    case 1608: return kDefaultScan16x8;
    case 1632: return kDefaultScan16x32;
    case 3216: return kDefaultScan32x16;
    case 416: return kDefaultScan4x16;
    case 1604: return kDefaultScan16x4;
    case 832: return kDefaultScan8x32;
    case 3208: return kDefaultScan32x8;
  }
  return nullptr;
}
const int16_t* mrow_scan(int w, int h) {
  using namespace av1t;
  switch (w * 100 + h) {
    case 404: return kMrowScan4x4;
    case 808: return kMrowScan8x8;
    case 1616: return kMrowScan16x16;
    case 408: return kMrowScan4x8;
    case 804: return kMrowScan8x4;
    case 816: return kMrowScan8x16;
    case 1608: return kMrowScan16x8;
    case 416: return kMrowScan4x16;
    case 1604: return kMrowScan16x4;
  }
  return nullptr;
}
const int16_t* mcol_scan(int w, int h) {
  using namespace av1t;
  switch (w * 100 + h) {
    case 404: return kMcolScan4x4;
    case 808: return kMcolScan8x8;
    case 1616: return kMcolScan16x16;
    case 408: return kMcolScan4x8;
    case 804: return kMcolScan8x4;
    case 816: return kMcolScan8x16;
    case 1608: return kMcolScan16x8;
    case 416: return kMcolScan4x16;
    case 1604: return kMcolScan16x4;
  }
  return nullptr;
}
const uint8_t* sm_weights(int log2) {  // Sm_Weights_Tx_4x4 .. Sm_Weights_Tx_64x64
  static const int off[5] = {0, 4, 12, 28, 60};
  return av1t::kSmWeights + off[log2 - 2];
}

// ---------------------------------------------------------------------------
// The inverse transforms (7.13.2), as libaom computes them: each butterfly
// rounds its product, each sum is clamped to the stage's range
// ---------------------------------------------------------------------------

struct Tx1d {
  int range;  // bits of the intermediate clamp
  int32_t clamp(int64_t v) const {
    const int64_t lo = -(1ll << (range - 1)), hi = (1ll << (range - 1)) - 1;
    return (int32_t)(v < lo ? lo : v > hi ? hi : v);
  }
  static int32_t btf(int w0, int32_t a, int w1, int32_t b) {  // half_btf at cos_bit 12
    return (int32_t)(((int64_t)w0 * a + (int64_t)w1 * b + 2048) >> 12);
  }
  static int cospi(int k) { return av1t::kCos128[k]; }
  static int brev(int bits, int x) {  // x's low ``bits`` bits reversed (bits 1 .. 5)
    static const struct Table {
      uint8_t v[6][32];
      Table() {
        for (int b = 1; b < 6; ++b)
          for (int x = 0; x < (1 << b); ++x) {
            int r = 0;
            for (int i = 0; i < b; ++i) r |= ((x >> i) & 1) << (b - 1 - i);
            v[b][x] = (uint8_t)r;
          }
      }
    } table;
    return table.v[bits][x];
  }

  // the odd half of an n-point inverse DCT, on its inputs in natural order
  void dct_odd(int32_t* a, int m) const {
    int lm = floor_log2((uint32_t)m), n = 2 * m;
    int32_t t[32], o[32];
    for (int i = 0; i < m; ++i) t[i] = a[brev(lm, i)];
    // the first rotations: (i, m - 1 - i)
    for (int i = 0; i < m / 2; ++i) {
      int th = (64 / n) * (n - 1 - 2 * brev(lm, i));
      o[i] = btf(cospi(th), t[i], -cospi(64 - th), t[m - 1 - i]);
      o[m - 1 - i] = btf(cospi(64 - th), t[i], cospi(th), t[m - 1 - i]);
    }
    for (int i = 0; i < m; ++i) t[i] = o[i];
    for (int level = 1; (1 << level) < m; ++level) {
      // sums and differences within groups of 2^level, mirrored, the odd groups reversed
      int g = 1 << level;
      for (int s = 0; s < m; s += g) {
        bool odd = (s / g) & 1;
        for (int k = 0; k < g / 2; ++k) {
          int32_t x = t[s + k], y = t[s + g - 1 - k];
          o[s + k] = odd ? clamp((int64_t)y - x) : clamp((int64_t)x + y);
          o[s + g - 1 - k] = odd ? clamp((int64_t)x + y) : clamp((int64_t)x - y);
        }
      }
      for (int i = 0; i < m; ++i) t[i] = o[i];
      int big = 2 << level;  // groups of 2^(level + 1) pair with their mirror group
      if (big >= m) {       // the last level: a rotation by pi/4 of the middle pairs
        for (int k = big / 4; k < big / 2; ++k) {
          o[k] = btf(-cospi(32), t[k], cospi(32), t[m - 1 - k]);
          o[m - 1 - k] = btf(cospi(32), t[k], cospi(32), t[m - 1 - k]);
        }
      } else {
        int np = 2 * m / big;  // the size of the inverse DCT whose first rotations these are
        int lp = floor_log2((uint32_t)(np / 2));
        for (int gi = 0; gi < m / big / 2; ++gi) {
          int th = (64 / np) * (np - 1 - 2 * brev(lp, gi)), s = gi * big;
          for (int k = s + big / 4; k < s + big / 2; ++k) {
            o[k] = btf(-cospi(64 - th), t[k], cospi(th), t[m - 1 - k]);
            o[m - 1 - k] = btf(cospi(th), t[k], cospi(64 - th), t[m - 1 - k]);
          }
          for (int k = s + big / 2; k < s + 3 * big / 4; ++k) {
            o[k] = btf(-cospi(th), t[k], -cospi(64 - th), t[m - 1 - k]);
            o[m - 1 - k] = btf(-cospi(64 - th), t[k], cospi(th), t[m - 1 - k]);
          }
        }
      }
      for (int i = 0; i < m; ++i) t[i] = o[i];
    }
    for (int i = 0; i < m; ++i) a[i] = t[i];
  }

  // the n-point inverse DCT (n = 4 .. 64), in place
  void dct(int32_t* x, int n) const {
    if (n == 2) {
      int32_t a = x[0], b = x[1];
      x[0] = btf(cospi(32), a, cospi(32), b);
      x[1] = btf(cospi(32), a, -cospi(32), b);
      return;
    }
    int m = n / 2;
    int32_t e[32], o[32];
    for (int i = 0; i < m; ++i) { e[i] = x[2 * i]; o[i] = x[2 * i + 1]; }
    dct(e, m);
    if (m == 2) {  // the odd half of the 4-point transform: one rotation
      int32_t a = o[0], b = o[1];
      o[0] = btf(cospi(48), a, -cospi(16), b);
      o[1] = btf(cospi(16), a, cospi(48), b);
    } else {
      dct_odd(o, m);
    }
    for (int k = 0; k < m; ++k) {
      x[k] = clamp((int64_t)e[k] + o[m - 1 - k]);
      x[n - 1 - k] = clamp((int64_t)e[k] - o[m - 1 - k]);
    }
  }

  static void adst4(int32_t* x) {
    const int32_t* s = av1t::kSinpi;
    int64_t x0 = x[0], x1 = x[1], x2 = x[2], x3 = x[3];
    int64_t s0 = s[1] * x0, s1 = s[2] * x0, s2 = s[3] * x1, s3 = s[4] * x2, s4 = s[1] * x2, s5 = s[2] * x3,
            s6 = s[4] * x3;
    int64_t s7 = (x0 - x2) + x3;
    s0 = s0 + s3;
    s1 = s1 - s4;
    s3 = s2;
    s2 = s[3] * s7;
    s0 = s0 + s5;
    s1 = s1 - s6;
    int64_t y0 = s0 + s3, y1 = s1 + s3, y2 = s2, y3 = s0 + s1;
    y3 = y3 - s3;
    x[0] = (int32_t)((y0 + 2048) >> 12);
    x[1] = (int32_t)((y1 + 2048) >> 12);
    x[2] = (int32_t)((y2 + 2048) >> 12);
    x[3] = (int32_t)((y3 + 2048) >> 12);
  }

  // the 8- and 16-point inverse ADST, in place
  void adst8(int32_t* x) const {
    static const int perm[8] = {7, 0, 5, 2, 3, 4, 1, 6};
    int32_t b[8], c[8];
    for (int i = 0; i < 8; ++i) b[i] = x[perm[i]];
    for (int k = 0; k < 4; ++k) {
      int th = 4 + 16 * k;
      c[2 * k] = btf(cospi(th), b[2 * k], cospi(64 - th), b[2 * k + 1]);
      c[2 * k + 1] = btf(cospi(64 - th), b[2 * k], -cospi(th), b[2 * k + 1]);
    }
    for (int k = 0; k < 4; ++k) {
      b[k] = clamp((int64_t)c[k] + c[k + 4]);
      b[k + 4] = clamp((int64_t)c[k] - c[k + 4]);
    }
    for (int k = 0; k < 4; ++k) c[k] = b[k];
    c[4] = btf(cospi(16), b[4], cospi(48), b[5]);
    c[5] = btf(cospi(48), b[4], -cospi(16), b[5]);
    c[6] = btf(-cospi(48), b[6], cospi(16), b[7]);
    c[7] = btf(cospi(16), b[6], cospi(48), b[7]);
    for (int s = 0; s < 8; s += 4) {
      b[s] = clamp((int64_t)c[s] + c[s + 2]);
      b[s + 1] = clamp((int64_t)c[s + 1] + c[s + 3]);
      b[s + 2] = clamp((int64_t)c[s] - c[s + 2]);
      b[s + 3] = clamp((int64_t)c[s + 1] - c[s + 3]);
    }
    for (int s = 0; s < 8; s += 4) {
      c[s] = b[s];
      c[s + 1] = b[s + 1];
      c[s + 2] = btf(cospi(32), b[s + 2], cospi(32), b[s + 3]);
      c[s + 3] = btf(cospi(32), b[s + 2], -cospi(32), b[s + 3]);
    }
    x[0] = c[0]; x[1] = -c[4]; x[2] = c[6]; x[3] = -c[2];
    x[4] = c[3]; x[5] = -c[7]; x[6] = c[5]; x[7] = -c[1];
  }

  void adst16(int32_t* x) const {
    static const int perm[16] = {15, 0, 13, 2, 11, 4, 9, 6, 7, 8, 5, 10, 3, 12, 1, 14};
    int32_t b[16], c[16];
    for (int i = 0; i < 16; ++i) b[i] = x[perm[i]];
    for (int k = 0; k < 8; ++k) {
      int th = 2 + 8 * k;
      c[2 * k] = btf(cospi(th), b[2 * k], cospi(64 - th), b[2 * k + 1]);
      c[2 * k + 1] = btf(cospi(64 - th), b[2 * k], -cospi(th), b[2 * k + 1]);
    }
    for (int k = 0; k < 8; ++k) {
      b[k] = clamp((int64_t)c[k] + c[k + 8]);
      b[k + 8] = clamp((int64_t)c[k] - c[k + 8]);
    }
    for (int k = 0; k < 8; ++k) c[k] = b[k];
    c[8] = btf(cospi(8), b[8], cospi(56), b[9]);
    c[9] = btf(cospi(56), b[8], -cospi(8), b[9]);
    c[10] = btf(cospi(40), b[10], cospi(24), b[11]);
    c[11] = btf(cospi(24), b[10], -cospi(40), b[11]);
    c[12] = btf(-cospi(56), b[12], cospi(8), b[13]);
    c[13] = btf(cospi(8), b[12], cospi(56), b[13]);
    c[14] = btf(-cospi(24), b[14], cospi(40), b[15]);
    c[15] = btf(cospi(40), b[14], cospi(24), b[15]);
    for (int s = 0; s < 16; s += 8)
      for (int k = s; k < s + 4; ++k) {
        b[k] = clamp((int64_t)c[k] + c[k + 4]);
        b[k + 4] = clamp((int64_t)c[k] - c[k + 4]);
      }
    for (int s = 0; s < 16; s += 8) {
      for (int k = s; k < s + 4; ++k) c[k] = b[k];
      c[s + 4] = btf(cospi(16), b[s + 4], cospi(48), b[s + 5]);
      c[s + 5] = btf(cospi(48), b[s + 4], -cospi(16), b[s + 5]);
      c[s + 6] = btf(-cospi(48), b[s + 6], cospi(16), b[s + 7]);
      c[s + 7] = btf(cospi(16), b[s + 6], cospi(48), b[s + 7]);
    }
    for (int s = 0; s < 16; s += 4) {
      b[s] = clamp((int64_t)c[s] + c[s + 2]);
      b[s + 1] = clamp((int64_t)c[s + 1] + c[s + 3]);
      b[s + 2] = clamp((int64_t)c[s] - c[s + 2]);
      b[s + 3] = clamp((int64_t)c[s + 1] - c[s + 3]);
    }
    for (int s = 0; s < 16; s += 4) {
      c[s] = b[s];
      c[s + 1] = b[s + 1];
      c[s + 2] = btf(cospi(32), b[s + 2], cospi(32), b[s + 3]);
      c[s + 3] = btf(cospi(32), b[s + 2], -cospi(32), b[s + 3]);
    }
    static const int out[16] = {0, 8, 12, 4, 6, 14, 10, 2, 3, 11, 15, 7, 5, 13, 9, 1};
    for (int i = 0; i < 16; ++i) x[i] = (i & 1) ? -c[out[i]] : c[out[i]];
  }

  static void identity(int32_t* x, int n) {
    for (int i = 0; i < n; ++i) {
      int64_t v = x[i];
      if (n == 4) x[i] = (int32_t)((v * 5793 + 2048) >> 12);
      else if (n == 8) x[i] = (int32_t)(v * 2);
      else if (n == 16) x[i] = (int32_t)((v * 2 * 5793 + 2048) >> 12);
      else x[i] = (int32_t)(v * 4);
    }
  }

  // kind: 0 DCT, 1 ADST, 2 identity
  void run(int32_t* x, int n, int kind) const {
    if (kind == 2) identity(x, n);
    else if (kind == 0) dct(x, n);
    else if (n == 4) adst4(x);
    else if (n == 8) adst8(x);
    else adst16(x);
  }
};

// 7.13.3: the 2D inverse transform of dequantized coefficients (the coded top-left part, at most 32x32,
// row-major) -> the residual [h][w]
void inverse_transform_2d(const int32_t* coef, int tx, int tx_type, int bd, int32_t* res) {
  // per type, the kind of the row (horizontal) and column transforms, and whether a flipped ADST reverses the
  // rows' outputs (left-right) or the columns' (upside down)
  static const int row_kind[16] = {0, 0, 1, 1, 0, 1, 1, 1, 1, 2, 2, 0, 2, 1, 2, 1};
  static const int col_kind[16] = {0, 1, 0, 1, 1, 0, 1, 1, 1, 2, 0, 2, 1, 2, 1, 2};
  static const bool flip_lr[16] = {0, 0, 0, 0, 0, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1};
  static const bool flip_ud[16] = {0, 0, 0, 0, 1, 0, 1, 0, 1, 0, 0, 0, 0, 0, 1, 0};
  const int lw = kTxWLog2[tx], lh = kTxHLog2[tx], w = 1 << lw, h = 1 << lh, tw = std::min(w, 32);
  const Tx1d rows{bd + 8}, cols{std::max(bd + 6, 16)};
  const int shift = kTxRowShift[tx];
  int32_t t[64];
  for (int i = 0; i < h; ++i) {
    int32_t* r = res + i * w;
    bool any = false;
    for (int j = 0; j < w; ++j) {
      int64_t v = (i < 32 && j < 32) ? coef[i * tw + j] : 0;
      if (std::abs(lw - lh) == 1) v = (v * 2896 + 2048) >> 12;
      t[j] = rows.clamp(v);
      any |= t[j] != 0;
    }
    if (any) {
      rows.run(t, w, row_kind[tx_type]);
      for (int j = 0; j < w; ++j)
        r[flip_lr[tx_type] ? w - 1 - j : j] = shift ? (int32_t)(((int64_t)t[j] + (1 << (shift - 1))) >> shift) : t[j];
    } else {
      for (int j = 0; j < w; ++j) r[j] = 0;
    }
  }
  for (int j = 0; j < w; ++j) {
    for (int i = 0; i < h; ++i) t[i] = cols.clamp(res[i * w + j]);
    cols.run(t, h, col_kind[tx_type]);
    for (int i = 0; i < h; ++i) res[(flip_ud[tx_type] ? h - 1 - i : i) * w + j] = (int32_t)(((int64_t)t[i] + 8) >> 4);
  }
}

}  // namespace

// What a refusal names (meta[4]); ops/avif.py holds the names
enum Tool {
  kToolSuperres = 5, kToolFilmGrain = 6, kToolNotKeyFrame = 7, kToolNotShown = 8, kToolLargeScaleTile = 9,
  kToolShowExisting = 10
};

namespace {

struct Corrupt {
  int line;
};
struct Unsupported {
  int tool;
};
struct TooLarge {};

// ---------------------------------------------------------------------------
// Bits: f(n), uvlc, leb128, su, ns, le
// ---------------------------------------------------------------------------

struct Bits {
  const uint8_t* p;
  int64_t size;  // bytes
  int64_t pos;   // bits
  uint32_t f(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; ++i) {
      if (pos >= size * 8) throw Corrupt{__LINE__};
      x = (x << 1) | ((p[pos >> 3] >> (7 - (pos & 7))) & 1);
      ++pos;
    }
    return x;
  }
  uint32_t uvlc() {
    int lead = 0;
    while (!f(1)) {
      if (++lead >= 32) return 0xFFFFFFFFu;
    }
    return lead ? (uint32_t)((1ull << lead) - 1 + f(lead)) : 0;
  }
  int su(int n) {
    int v = (int)f(n);
    int sign = 1 << (n - 1);
    return (v & sign) ? v - 2 * sign : v;
  }
  uint32_t ns(uint32_t n) {
    int w = floor_log2(n) + 1;
    uint32_t m = (1u << w) - n;
    uint32_t v = f(w - 1);
    if (v < m) return v;
    return (v << 1) - m + f(1);
  }
  void byte_alignment() {  // libaom fails on a bit 1 here
    while (pos & 7)
      if (f(1)) throw Corrupt{__LINE__};
  }
  // trailing_bits as libaom checks them: a one, then zeros to the end of the OBU
  void trailing(int64_t end_bits) {
    if (pos >= end_bits) throw Corrupt{__LINE__};
    if (f(1) != 1) throw Corrupt{__LINE__};
    while (pos < end_bits)
      if (f(1)) throw Corrupt{__LINE__};
  }
};

uint64_t leb128(const uint8_t* p, int64_t n, int64_t* at) {
  uint64_t v = 0;
  for (int i = 0; i < 8; ++i) {
    if (*at >= n) throw Corrupt{__LINE__};
    uint8_t b = p[(*at)++];
    v |= (uint64_t)(b & 0x7F) << (7 * i);
    if (!(b & 0x80)) return v;
  }
  return v;
}

// ---------------------------------------------------------------------------
// The symbol decoder (section 8.2)
// ---------------------------------------------------------------------------

struct Symbol {
  const uint8_t* p;
  int64_t size, pos;  // bytes; the next unread bit
  int64_t max_bits;
  uint32_t value, range;
  bool adapt;
  uint32_t bits(int n) {  // the next n bits, zeros past the data
    uint32_t x = 0;
    while (n > 0) {
      int64_t at = pos >> 3;
      int off = (int)(pos & 7), take = std::min(n, 8 - off);
      uint32_t byte = at < size ? p[at] : 0;
      x = (x << take) | ((byte >> (8 - off - take)) & ((1u << take) - 1));
      pos += take;
      n -= take;
    }
    return x;
  }
  void init(const uint8_t* data, int64_t sz, bool disable_update) {
    p = data; size = sz; pos = 0; adapt = !disable_update;
    int num = (int)std::min<int64_t>(sz * 8, 15);
    uint32_t buf = bits(num);
    value = ((1u << 15) - 1) ^ (buf << (15 - num));
    range = 1u << 15;
    max_bits = 8 * sz - 15;
  }
  int read(uint16_t* cdf, int n) {
    uint32_t cur = range, prev;
    int s = -1;
    do {
      ++s;
      prev = cur;
      uint32_t f = (1u << 15) - cdf[s];
      cur = ((range >> 8) * (f >> 6) >> 1) + 4 * (uint32_t)(n - s - 1);
    } while (value < cur);
    range = prev - cur;
    value -= cur;
    int b = 15 - floor_log2(range);
    range <<= b;
    int num = (int)std::min<int64_t>(b, std::max<int64_t>(0, max_bits));
    uint32_t data = bits(num) << (b - num);
    value = data ^ (((value + 1) << b) - 1);
    max_bits -= b;
    if (adapt && cdf) {
      int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + std::min(floor_log2(n), 2);
      uint32_t tmp = 0;
      for (int i = 0; i < n - 1; ++i) {
        if (i == s) tmp = 1u << 15;
        if (tmp < cdf[i]) cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
        else cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
      }
      cdf[n] += cdf[n] < 32;
    }
    return s;
  }
  int read_fixed(const uint16_t* cdf, int n) {  // a computed CDF: no adaptation
    bool a = adapt;
    adapt = false;
    int s = read(const_cast<uint16_t*>(cdf), n);
    adapt = a;
    return s;
  }
  int boolean() {
    static const uint16_t half[3] = {1 << 14, 1 << 15, 0};
    return read_fixed(half, 2);
  }
  // od_ec_dec_tell: the bits consumed, plus the one an encoder reserves to end the stream
  int64_t tell() const { return 8 * size - 14 - max_bits; }
  // libaom's aom_reader_has_overflowed: more bits told than the tile holds (the specification requires
  // SymbolMaxBits >= -14)
  bool overflowed() const { return (tell() + 7) >> 3 > size; }
  // libaom's check_trailing_bits_after_symbol_coder: the reserved bit 1, then zeros to the tile's end
  bool trailing_ok() const {
    if (overflowed()) return false;
    int64_t nb = (tell() + 7) >> 3;
    uint8_t pattern = (uint8_t)(128 >> ((tell() - 1) & 7));
    if ((p[nb - 1] & (2 * pattern - 1)) != pattern) return false;
    for (int64_t k = nb; k < size; ++k)
      if (p[k]) return false;
    return true;
  }
};

// ---------------------------------------------------------------------------
// Headers
// ---------------------------------------------------------------------------

struct Sequence {
  bool seen = false;
  int profile, still, reduced;
  int frame_width_bits, frame_height_bits, max_width, max_height;
  int frame_id_numbers, delta_frame_id_len, frame_id_len;
  int sb128, filter_intra, edge_filter;
  int force_screen_content, force_integer_mv, order_hint_bits;
  int superres, cdef, restoration;
  int bit_depth, mono, cp, tc, mc, range, ssx, ssy, separate_uv_delta_q;
  int film_grain;
  int decoder_model_info, equal_picture_interval, buffer_delay_len, buffer_removal_time_len, frame_presentation_len;
  int op_count;
  int op_idc[32], decoder_model_present[32];
};

struct Cdfs {
  uint16_t partition8[4][5], partition16[12][11], partition128[4][9];
  uint16_t kf_y[25][14], uv_no_cfl[13][14], uv_cfl[13][15], angle[8][8], skip[3][3], filter_intra[22][3];
  uint16_t filter_intra_mode[6], cfl_sign[9], cfl_alpha[6][17];
  uint16_t intra_tx1[2][13][8], intra_tx2[3][13][6], tx8[3][3], tx16[3][4], tx32[3][4], tx64[3][4];
  uint16_t delta_q[5], delta_lf[5], delta_lf_multi[4][5];
  // the coefficient CDFs of the frame's q context
  uint16_t txb_skip[5][13][3], eob16[2][2][6], eob32[2][2][7], eob64[2][2][8], eob128[2][2][9], eob256[2][2][10];
  uint16_t eob512[2][11], eob1024[2][12], eob_extra[5][2][9][3], base_eob[5][2][4][4], base[5][2][42][5];
  uint16_t br[5][2][21][5], dc_sign[2][3][3];
  uint16_t restoration_type[4], use_wiener[3], use_sgrproj[3];
  uint16_t palette_y_mode[7][3][3], palette_uv_mode[2][3], palette_y_size[7][8], palette_uv_size[7][8];
  uint16_t palette_color[2][7][5][9];  // [Y, UV][palette size - 2][colour context]
  // intra block copy: use_intrabc, the MV CDFs of MV_INTRABC_CONTEXT (per component: row, column), the transform
  // split flag of inter blocks and the inter transform types of sets 1, 2, 3 by square size
  uint16_t intrabc[3], mv_joint[5], mv_class[2][12], mv_sign[2][3], mv_class0[2][3], mv_bits[2][10][3];
  uint16_t txfm_split[21][3], inter_tx1[4][17], inter_tx2[4][13], inter_tx3[4][3];
  uint16_t spatial_seg[3][9];  // the segment id, by how many of its neighbours' ids agree
  void reset(int qctx) {
    using namespace av1t;
    std::memcpy(partition8, kPartition8, sizeof partition8);
    std::memcpy(partition16, kPartition16, sizeof partition16);
    std::memcpy(partition128, kPartition128, sizeof partition128);
    std::memcpy(kf_y, kKfYMode, sizeof kf_y);
    for (int i = 0; i < 13; ++i) {
      std::memcpy(uv_no_cfl[i], kUvModeNoCfl[i], sizeof uv_no_cfl[i]);
      std::memcpy(uv_cfl[i], kUvModeCfl[i], sizeof uv_cfl[i]);
    }
    std::memcpy(angle, kAngleDelta, sizeof angle);
    std::memcpy(skip, kSkip, sizeof skip);
    std::memcpy(filter_intra, kFilterIntra, sizeof filter_intra);
    std::memcpy(filter_intra_mode, kFilterIntraMode, sizeof filter_intra_mode);
    std::memcpy(cfl_sign, kCflSign, sizeof cfl_sign);
    std::memcpy(cfl_alpha, kCflAlpha, sizeof cfl_alpha);
    std::memcpy(intra_tx1, kIntraTxTypeSet1Cdf, sizeof intra_tx1);
    std::memcpy(intra_tx2, kIntraTxTypeSet2Cdf, sizeof intra_tx2);
    std::memcpy(tx8, kTx8x8Cdf, sizeof tx8);
    std::memcpy(tx16, kTx16x16Cdf, sizeof tx16);
    std::memcpy(tx32, kTx32x32Cdf, sizeof tx32);
    std::memcpy(tx64, kTx64x64Cdf, sizeof tx64);
    std::memcpy(delta_q, kDeltaQCdf, sizeof delta_q);
    std::memcpy(delta_lf, kDeltaQCdf, sizeof delta_lf);  // Default_Delta_Lf_Cdf equals Default_Delta_Q_Cdf
    for (int i = 0; i < 4; ++i) std::memcpy(delta_lf_multi[i], kDeltaQCdf, sizeof delta_lf_multi[i]);
    std::memcpy(txb_skip, kTxbSkipCdf[qctx], sizeof txb_skip);
    std::memcpy(eob16, kEobPt16Cdf[qctx], sizeof eob16);
    std::memcpy(eob32, kEobPt32Cdf[qctx], sizeof eob32);
    std::memcpy(eob64, kEobPt64Cdf[qctx], sizeof eob64);
    std::memcpy(eob128, kEobPt128Cdf[qctx], sizeof eob128);
    std::memcpy(eob256, kEobPt256Cdf[qctx], sizeof eob256);
    std::memcpy(eob512, kEobPt512Cdf[qctx], sizeof eob512);
    std::memcpy(eob1024, kEobPt1024Cdf[qctx], sizeof eob1024);
    std::memcpy(eob_extra, kEobExtraCdf[qctx], sizeof eob_extra);
    std::memcpy(base_eob, kCoeffBaseEobCdf[qctx], sizeof base_eob);
    std::memcpy(base, kCoeffBaseCdf[qctx], sizeof base);
    std::memcpy(br, kCoeffBrCdf[qctx], sizeof br);
    std::memcpy(dc_sign, kDcSignCdf[qctx], sizeof dc_sign);
    std::memcpy(restoration_type, kSwitchableRestoreCdf, sizeof restoration_type);
    std::memcpy(use_wiener, kWienerRestoreCdf, sizeof use_wiener);
    std::memcpy(use_sgrproj, kSgrprojRestoreCdf, sizeof use_sgrproj);
    std::memcpy(palette_y_mode, kPaletteYModeCdf, sizeof palette_y_mode);
    std::memcpy(palette_uv_mode, kPaletteUvModeCdf, sizeof palette_uv_mode);
    std::memcpy(palette_y_size, kPaletteYSizeCdf, sizeof palette_y_size);
    std::memcpy(palette_uv_size, kPaletteUvSizeCdf, sizeof palette_uv_size);
    std::memcpy(palette_color[0], kPaletteYColorCdf, sizeof palette_color[0]);
    std::memcpy(palette_color[1], kPaletteUvColorCdf, sizeof palette_color[1]);
    std::memcpy(intrabc, kIntrabcCdf, sizeof intrabc);
    std::memcpy(mv_joint, kMvJointCdf, sizeof mv_joint);
    std::memcpy(mv_class, kMvClassCdf, sizeof mv_class);
    std::memcpy(mv_sign, kMvSignCdf, sizeof mv_sign);
    std::memcpy(mv_class0, kMvClass0BitCdf, sizeof mv_class0);
    std::memcpy(mv_bits, kMvBitsCdf, sizeof mv_bits);
    std::memcpy(txfm_split, kTxfmSplitCdf, sizeof txfm_split);
    std::memcpy(inter_tx1, kInterTxTypeSet1Cdf, sizeof inter_tx1);
    std::memcpy(inter_tx2, kInterTxTypeSet2Cdf, sizeof inter_tx2);
    std::memcpy(inter_tx3, kInterTxTypeSet3Cdf, sizeof inter_tx3);
    std::memcpy(spatial_seg, kSpatialPredSegCdf, sizeof spatial_seg);
  }
};

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Decoder {
  Sequence seq;
  // the frame header
  int width = 0, height = 0, mi_cols = 0, mi_rows = 0;
  int disable_cdf_update = 0, allow_screen_content = 0, allow_intrabc = 0;
  int tile_cols = 0, tile_rows = 0, tile_cols_log2 = 0, tile_rows_log2 = 0, tile_size_bytes = 0;
  std::vector<int> mi_col_starts, mi_row_starts;
  int base_q_idx = 0, delta_q_dc[3] = {0, 0, 0}, delta_q_ac[3] = {0, 0, 0};
  int delta_q_present = 0, delta_q_res = 0;
  // segmentation_params: whether it is on, each segment's features (a bit per SEG_LVL_*) and their data, the last
  // segment with a feature (LastActiveSegId) and whether the id is read before skip (SegIdPreSkip)
  int seg_enabled = 0, seg_features[8] = {}, seg_data[8][8] = {}, last_active_seg = 0, seg_preskip = 0;
  // per segment: its quantizer index without delta q (get_qindex(1, ·)), LosslessArray, SegQMLevel per plane; and
  // CodedLossless (every segment lossless), which AllLossless equals without superres
  int seg_qindex[8] = {}, seg_lossless[8] = {}, seg_qm_level[8][3] = {}, coded_lossless = 0;
  // delta_lf_params: whether each superblock codes deltas to the loop filter levels, their multiplier (1 << the
  // coded delta_lf_res) and whether there is one per plane and direction (FRAME_LF_COUNT) or one for all
  int delta_lf_present = 0, delta_lf_res = 1, delta_lf_multi = 0;
  int cdef_bits = 0, tx_mode_select = 0, reduced_tx_set = 0;
  // cdef_params: the damping and, per entry, the Y and UV primary and secondary strengths (3 read as 4)
  int cdef_damping = 3, cdef_y_pri[8] = {}, cdef_y_sec[8] = {}, cdef_uv_pri[8] = {}, cdef_uv_sec[8] = {};
  // loop_filter_params: the levels (Y vertical edges, Y horizontal, U, V), sharpness, the deltas
  int lf_level[4] = {0, 0, 0, 0}, lf_sharpness = 0, lf_delta_enabled = 0;
  int lf_ref_deltas[8] = {1, 0, 0, 0, -1, 0, -1, -1}, lf_mode_deltas[2] = {0, 0};
  // lr_params: per plane, the frame's restoration type (kRestore*), its unit size and the units in a row and column
  int lr_type[3] = {0, 0, 0}, lr_unit_size[3] = {256, 256, 256}, lr_rows[3] = {0, 0, 0}, lr_cols[3] = {0, 0, 0};
  bool seen_frame_header = false, decoded = false;
  int next_tile = 0;
  Cdfs frame_cdfs, cdf;
  // the frame: plane p has pw[p] x ph[p] samples (the 8x8-aligned frame, subsampled)
  int planes = 0, pw[3] = {0, 0, 0}, ph[3] = {0, 0, 0}, stride[3] = {0, 0, 0};
  std::vector<uint16_t> frame[3];
  // per 4x4 unit of the frame
  std::vector<uint8_t> y_modes, uv_modes, mi_sizes, skips, tx_sizes, tx_types;
  std::vector<int8_t> cdef_idx;  // per 64x64
  // under segmentation: per 4x4 unit of the frame its block's segment id
  std::vector<uint8_t> segment_ids;
  // what the frame's segmentation coded (meta[20..21]): a bit per segment id a block took, and a bit per path taken
  // (kSeg*)
  int seg_ids_used = 0, seg_paths = 0;
  // under delta LF: per 4x4 unit of the frame its block's DeltaLF[0..3] (only [0] without delta_lf_multi)
  std::vector<int8_t> delta_lfs;
  // what the frame's delta LF coded (meta[18..19]): the blocks whose deltas are not all 0, and a bit per path taken
  // (kLf*)
  int delta_lf_blocks = 0, delta_lf_paths = 0;
  // under intra block copy: per 4x4 unit of the frame whether its block copies (an inter block of INTRA_FRAME) and
  // its block vector; per mode info column (above) and row (left) the width or height in pixels of the transform
  // last coded there (the contexts of the transform split flag, 64 where none was)
  struct Mv {
    int16_t row, col;  // 1/8 pixels
    bool operator==(const Mv& o) const { return row == o.row && col == o.col; }
  };
  std::vector<uint8_t> is_inters;
  std::vector<Mv> dvs;
  std::vector<uint8_t> above_txfm, left_txfm;
  // what the frame's intra block copy coded (meta[15..17]): its blocks, those whose DV stack held a candidate, and
  // a bit per path taken (kPath*)
  int intrabc_blocks = 0, intrabc_stacked = 0, intrabc_paths = 0;
  // under screen content tools: the palettes of the blocks that have one, and per 4x4 unit of the frame the index of
  // its block's there (-1: none)
  struct Palette {
    uint8_t n[2];         // PaletteSizeY, PaletteSizeUV
    uint16_t colors[2][8];  // Y's and U's, ascending (the cache of a later block merges them)
  };
  std::vector<Palette> palettes;
  std::vector<int32_t> palette_of;
  // what the frame's palettes coded (meta[11..14]): a bit per palette size of Y and of UV, the colours taken from a
  // cache, the V colours coded as deltas
  int palette_y_sizes = 0, palette_uv_sizes = 0, palette_cached = 0, palette_v_deltas = 0;
  // per plane: each restoration unit's type and coefficients (row-major), the references the next unit's are
  // coded against, the deblocked planes (kept through CDEF for the rows around each restoration stripe)
  struct LrUnit {
    uint8_t type, set;
    int8_t wiener[2][3];  // the vertical, then the horizontal filter's outer three taps
    int16_t xqd[2];
  };
  std::vector<LrUnit> lr_units[3];
  int ref_wiener[3][2][3], ref_sgr[3][2];
  std::vector<uint16_t> pre_cdef[3];
  // coefficient contexts, per plane
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  uint8_t block_decoded_[3][34][34];
  // the tile
  int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
  int current_q = 0, read_deltas = 0, delta_lf[4] = {0, 0, 0, 0};
  Symbol sym;
  // the block
  int mi_row, mi_col, mi_size, has_chroma, avail_u, avail_l, avail_u_chroma, avail_l_chroma;
  int segment_id, lossless, skip, y_mode, uv_mode, angle_y, angle_uv, tx_size, partition, use_intrabc;
  Mv dv;
  uint8_t inter_tx[32][32];  // an intra block copy's transform size per 4x4 luma unit of the block
  int use_filter_intra, filter_intra_mode, cfl_alpha_u, cfl_alpha_v, max_luma_w, max_luma_h;
  // the block's palettes: Y's and UV's sizes, the colours of Y, U and V, the colour index maps of Y and UV (row-major,
  // map_w[k] wide)
  int palette_size[2], map_w[2];
  uint16_t palette_colors[3][8];
  uint8_t color_map[2][64 * 64];
  // scratch of a transform block
  int32_t quant[1024], dequant[1024], resid[4096];

  uint8_t& block_decoded(int plane, int r, int c) { return block_decoded_[plane][r + 1][c + 1]; }
  uint16_t& px(int plane, int y, int x) { return frame[plane][(int64_t)y * stride[plane] + x]; }
  int ssx(int plane) const { return plane ? seq.ssx : 0; }
  int ssy(int plane) const { return plane ? seq.ssy : 0; }

  // ---- sequence header (5.5) ----
  void sequence_header(Bits& b) {
    Sequence s;
    s.seen = true;
    s.profile = b.f(3);
    s.still = b.f(1);
    s.reduced = b.f(1);
    s.decoder_model_info = 0;
    s.equal_picture_interval = 0;
    if (s.profile > 2) throw Corrupt{__LINE__};  // libaom: an invalid profile
    if (s.reduced && !s.still) throw Corrupt{__LINE__};
    if (s.reduced) {
      s.op_count = 1;
      s.op_idc[0] = 0;
      s.decoder_model_present[0] = 0;
      level_check(b.f(5));
    } else {
      int timing = b.f(1);
      if (timing) {
        if (!b.f(32) || !b.f(32)) throw Corrupt{__LINE__};  // libaom: a display tick and time scale above 0
        s.equal_picture_interval = b.f(1);
        if (s.equal_picture_interval) {
          if (b.uvlc() == 0xFFFFFFFFu) throw Corrupt{__LINE__};
        }
        s.decoder_model_info = b.f(1);
        if (s.decoder_model_info) {
          s.buffer_delay_len = b.f(5) + 1;
          b.f(32);  // num_units_in_decoding_tick
          s.buffer_removal_time_len = b.f(5) + 1;
          s.frame_presentation_len = b.f(5) + 1;
        }
      }
      int initial_display_delay = b.f(1);
      s.op_count = b.f(5) + 1;
      for (int i = 0; i < s.op_count; ++i) {
        s.op_idc[i] = b.f(12);
        int level = b.f(5);
        level_check(level);
        if (level > 7) b.f(1);
        s.decoder_model_present[i] = 0;
        if (s.decoder_model_info) {
          s.decoder_model_present[i] = b.f(1);
          if (s.decoder_model_present[i]) {
            b.f(s.buffer_delay_len); b.f(s.buffer_delay_len); b.f(1);  // operating_parameters_info
          }
        }
        if (initial_display_delay) {  // libaom: at most 10 frames
          if (b.f(1) && b.f(4) + 1 > 10) throw Corrupt{__LINE__};
        }
      }
    }
    s.frame_width_bits = b.f(4) + 1;
    s.frame_height_bits = b.f(4) + 1;
    s.max_width = b.f(s.frame_width_bits) + 1;
    s.max_height = b.f(s.frame_height_bits) + 1;
    s.frame_id_numbers = s.reduced ? 0 : b.f(1);
    if (s.frame_id_numbers) {
      s.delta_frame_id_len = b.f(4) + 2;
      s.frame_id_len = b.f(3) + s.delta_frame_id_len + 1;
    }
    s.sb128 = b.f(1);
    s.filter_intra = b.f(1);
    s.edge_filter = b.f(1);
    if (s.reduced) {
      s.force_screen_content = 2;
      s.force_integer_mv = 2;
      s.order_hint_bits = 0;
    } else {
      b.f(1); b.f(1); b.f(1); b.f(1);  // interintra, masked compound, warped motion, dual filter
      int order_hint = b.f(1);
      if (order_hint) { b.f(1); b.f(1); }  // jnt_comp, ref_frame_mvs
      s.force_screen_content = b.f(1) ? 2 : b.f(1);
      if (s.force_screen_content > 0) s.force_integer_mv = b.f(1) ? 2 : b.f(1);
      else s.force_integer_mv = 2;
      s.order_hint_bits = order_hint ? b.f(3) + 1 : 0;
    }
    s.superres = b.f(1);
    s.cdef = b.f(1);
    s.restoration = b.f(1);
    // color_config
    int high = b.f(1);
    if (s.profile == 2 && high) s.bit_depth = b.f(1) ? 12 : 10;
    else s.bit_depth = high ? 10 : 8;
    s.mono = s.profile == 1 ? 0 : b.f(1);
    int desc = b.f(1);
    s.cp = s.tc = s.mc = 2;
    if (desc) { s.cp = b.f(8); s.tc = b.f(8); s.mc = b.f(8); }
    s.separate_uv_delta_q = 0;
    if (s.mono) {
      s.range = b.f(1);
      s.ssx = s.ssy = 1;
    } else {
      if (s.cp == 1 && s.tc == 13 && s.mc == 0) {
        s.range = 1;
        s.ssx = s.ssy = 0;
        // libaom: sRGB needs profile 1, or profile 2 at 12 bits
        if (!(s.profile == 1 || (s.profile == 2 && s.bit_depth == 12))) throw Corrupt{__LINE__};
      } else {
        s.range = b.f(1);
        if (s.profile == 0) { s.ssx = s.ssy = 1; }
        else if (s.profile == 1) { s.ssx = s.ssy = 0; }
        else if (s.bit_depth == 12) {
          s.ssx = b.f(1);
          s.ssy = s.ssx ? b.f(1) : 0;
        } else { s.ssx = 1; s.ssy = 0; }
        if (s.mc == 0 && (s.ssx || s.ssy)) throw Corrupt{__LINE__};  // libaom: the identity matrix needs 4:4:4
        if (s.ssx && s.ssy) b.f(2);  // chroma_sample_position
      }
      s.separate_uv_delta_q = b.f(1);
    }
    s.film_grain = b.f(1);
    seq = s;
  }

  // ---- the uncompressed header of a key frame (5.9) ----
  void frame_header(Bits& b) {
    if (!seq.seen) throw Corrupt{__LINE__};
    int show_frame = 1, frame_type = 0;
    if (!seq.reduced) {
      if (b.f(1)) throw Unsupported{kToolShowExisting};
      frame_type = b.f(2);
      show_frame = b.f(1);
      if (frame_type != 0) throw Unsupported{kToolNotKeyFrame};
      if (!show_frame) throw Unsupported{kToolNotShown};
      if (seq.decoder_model_info && !seq.equal_picture_interval) b.f(seq.frame_presentation_len);
    }
    disable_cdf_update = b.f(1);
    allow_screen_content = seq.force_screen_content == 2 ? b.f(1) : seq.force_screen_content;
    if (allow_screen_content && seq.force_integer_mv == 2) b.f(1);  // force_integer_mv: a key frame has no motion
    if (seq.frame_id_numbers) b.f(seq.frame_id_len);
    int size_override = seq.reduced ? 0 : b.f(1);
    b.f(seq.order_hint_bits);
    if (seq.decoder_model_info) {
      if (b.f(1)) {
        for (int op = 0; op < seq.op_count; ++op) {
          if (seq.decoder_model_present[op]) {
            int idc = seq.op_idc[op];
            if (idc == 0 || ((idc & 1) && (idc >> 8 & 1))) b.f(seq.buffer_removal_time_len);
          }
        }
      }
    }
    // frame_size, superres_params, render_size
    if (size_override) {
      width = b.f(seq.frame_width_bits) + 1;
      height = b.f(seq.frame_height_bits) + 1;
    } else {
      width = seq.max_width;
      height = seq.max_height;
    }
    if (width > seq.max_width || height > seq.max_height) throw Corrupt{__LINE__};
    // libavif's limits (AVIF_DEFAULT_IMAGE_DIMENSION_LIMIT, AVIF_DEFAULT_IMAGE_SIZE_LIMIT), held before
    // start_frame allocates: a header may ask for up to 65536x65536
    if (width > 32768 || height > 32768 || (int64_t)width * height > 16384 * 16384) throw TooLarge{};
    if (seq.superres && b.f(1)) throw Unsupported{kToolSuperres};
    if (b.f(1)) { b.f(16); b.f(16); }  // render size: libaom decodes at the frame size
    // allow_intrabc (the upscaled width is the frame's: superres is refused above)
    allow_intrabc = allow_screen_content ? b.f(1) : 0;
    mi_cols = 2 * ((width + 7) >> 3);
    mi_rows = 2 * ((height + 7) >> 3);
    // disable_frame_end_update_cdf
    if (!seq.reduced && !disable_cdf_update) b.f(1);
    tile_info(b);
    // quantization_params
    base_q_idx = b.f(8);
    auto delta_q = [&]() { return b.f(1) ? b.su(7) : 0; };
    for (int p = 0; p < 3; ++p) delta_q_dc[p] = delta_q_ac[p] = 0;
    delta_q_dc[0] = delta_q();
    int sep = 0;
    if (seq.mono == 0) {
      int diff = seq.separate_uv_delta_q ? b.f(1) : 0;
      delta_q_dc[1] = delta_q();
      delta_q_ac[1] = delta_q();
      delta_q_dc[2] = delta_q_dc[1];
      delta_q_ac[2] = delta_q_ac[1];
      if (diff) {
        delta_q_dc[2] = delta_q();
        delta_q_ac[2] = delta_q();
      }
      sep = seq.separate_uv_delta_q;
    }
    int using_qmatrix = b.f(1), qm[3] = {15, 15, 15};
    if (using_qmatrix) {
      qm[0] = b.f(4);
      qm[1] = b.f(4);
      qm[2] = sep ? b.f(4) : qm[1];
    }
    segmentation_params(b);
    // delta_q_params, delta_lf_params
    delta_q_present = base_q_idx > 0 ? b.f(1) : 0;
    delta_q_res = delta_q_present ? b.f(2) : 0;
    delta_lf_present = delta_q_present && !allow_intrabc ? b.f(1) : 0;
    delta_lf_res = 1;
    delta_lf_multi = 0;
    if (delta_lf_present) {
      delta_lf_res = 1 << b.f(2);
      delta_lf_multi = b.f(1);
    }
    coded_lossless = 1;
    for (int s = 0; s < 8; ++s) {  // 5.9.2's tail: each segment's quantizer, lossless flag and matrix levels
      seg_qindex[s] = qindex(1, s);
      seg_lossless[s] = seg_qindex[s] == 0 && delta_q_dc[0] == 0 && delta_q_dc[1] == 0 && delta_q_ac[1] == 0 &&
                        delta_q_dc[2] == 0 && delta_q_ac[2] == 0;
      coded_lossless = coded_lossless && seg_lossless[s];
      for (int p = 0; p < 3; ++p) seg_qm_level[s][p] = (seg_lossless[s] || !using_qmatrix) ? 15 : qm[p];
    }
    cdef_bits = 0;
    cdef_damping = 3;
    for (int i = 0; i < 8; ++i) cdef_y_pri[i] = cdef_y_sec[i] = cdef_uv_pri[i] = cdef_uv_sec[i] = 0;
    for (int i = 0; i < 4; ++i) lf_level[i] = 0;
    lf_sharpness = lf_delta_enabled = 0;
    for (int p = 0; p < 3; ++p) {
      lr_type[p] = kRestoreNone;
      lr_unit_size[p] = 256;
    }
    if (!coded_lossless && !allow_intrabc) {  // intra block copy codes no in-loop filter: each stays off
      // loop_filter_params, the deltas from setup_past_independence's defaults
      lf_level[0] = b.f(6);
      lf_level[1] = b.f(6);
      if (seq.mono == 0 && (lf_level[0] || lf_level[1])) {
        lf_level[2] = b.f(6);
        lf_level[3] = b.f(6);
      }
      lf_sharpness = b.f(3);
      lf_delta_enabled = b.f(1);
      if (lf_delta_enabled && b.f(1)) {  // loop_filter_delta_update
        for (int i = 0; i < 8; ++i)
          if (b.f(1)) lf_ref_deltas[i] = b.su(7);
        for (int i = 0; i < 2; ++i)
          if (b.f(1)) lf_mode_deltas[i] = b.su(7);
      }
      // cdef_params
      if (seq.cdef) {
        cdef_damping = b.f(2) + 3;
        cdef_bits = b.f(2);
        for (int i = 0; i < (1 << cdef_bits); ++i) {
          cdef_y_pri[i] = b.f(4);
          cdef_y_sec[i] = b.f(2);
          cdef_y_sec[i] += cdef_y_sec[i] == 3;
          if (seq.mono == 0) {
            cdef_uv_pri[i] = b.f(4);
            cdef_uv_sec[i] = b.f(2);
            cdef_uv_sec[i] += cdef_uv_sec[i] == 3;
          }
        }
      }
      // lr_params
      if (seq.restoration) {
        static const int kRemapLrType[4] = {kRestoreNone, kRestoreSwitchable, kRestoreWiener, kRestoreSgrproj};
        bool any = false, chroma = false;
        for (int p = 0; p < (seq.mono ? 1 : 3); ++p) {
          lr_type[p] = kRemapLrType[b.f(2)];
          any = any || lr_type[p];
          chroma = chroma || (p && lr_type[p]);
        }
        if (any) {
          int shift = b.f(1);
          if (seq.sb128) ++shift;
          else if (shift) shift += b.f(1);
          lr_unit_size[0] = 256 >> (2 - shift);
          const int uv_shift = seq.ssx && seq.ssy && chroma ? b.f(1) : 0;
          lr_unit_size[1] = lr_unit_size[2] = lr_unit_size[0] >> uv_shift;
        }
      }
    }
    tx_mode_select = coded_lossless ? 0 : b.f(1);  // tx_mode: ONLY_4X4 when lossless, TX_MODE_SELECT, TX_MODE_LARGEST
    reduced_tx_set = b.f(1);
    if (seq.film_grain && b.f(1)) throw Unsupported{kToolFilmGrain};  // apply_grain
  }

  // 5.9.14 (libaom's setup_segmentation): a shown key frame has no primary reference frame, so the map and the
  // data are coded (update_map 1, temporal_update 0, update_data 1). Each feature's data has Segmentation_Feature_Bits
  // bits, signed ones one more, and is clamped to Segmentation_Feature_Max.
  void segmentation_params(Bits& b) {
    static const int kBits[8] = {8, 6, 6, 6, 6, 3, 0, 0}, kSigned[8] = {1, 1, 1, 1, 1, 0, 0, 0};
    static const int kMax[8] = {255, 63, 63, 63, 63, 7, 0, 0};
    seg_enabled = b.f(1);
    seg_preskip = last_active_seg = 0;
    for (int s = 0; s < 8; ++s) {
      seg_features[s] = 0;
      for (int j = 0; j < 8; ++j) {
        seg_data[s][j] = 0;
        if (!seg_enabled || !b.f(1)) continue;
        seg_features[s] |= 1 << j;
        int v = kSigned[j] ? b.su(1 + kBits[j]) : b.f(kBits[j]);
        seg_data[s][j] = std::min(kMax[j], std::max(-kMax[j], v));
        seg_preskip |= j >= kSegLvlRefFrame;
        last_active_seg = s;
      }
    }
  }

  enum { kSegLvlAltQ = 0, kSegLvlAltLfYV = 1, kSegLvlRefFrame = 5, kSegLvlSkip = 6 };
  bool seg_feature(int s, int j) const { return (seg_features[s] >> j) & 1; }

  // 7.12.2 get_qindex: the segment's quantizer index, from CurrentQIndex under delta q unless ``ignore_delta_q``
  int qindex(int ignore_delta_q, int s) const {
    const int base = !ignore_delta_q && delta_q_present ? current_q : base_q_idx;
    if (seg_feature(s, kSegLvlAltQ)) return std::min(255, std::max(0, base + seg_data[s][kSegLvlAltQ]));
    return base;
  }

  // libaom's is_valid_seq_level_idx: levels 2.0 to 6.3 but x.2 and x.3 of 2 to 4, and 31
  static void level_check(int level) {
    if (level == 31) return;
    if (level > 19 || (level < 12 && (level & 2))) throw Corrupt{__LINE__};
  }

  static int tile_log2(int blk, int target) {
    int k = 0;
    while ((blk << k) < target) ++k;
    return k;
  }

  void tile_info(Bits& b) {
    int sb_cols = seq.sb128 ? (mi_cols + 31) >> 5 : (mi_cols + 15) >> 4;
    int sb_rows = seq.sb128 ? (mi_rows + 31) >> 5 : (mi_rows + 15) >> 4;
    int sb_shift = seq.sb128 ? 5 : 4;
    int sb_size = sb_shift + 2;
    int max_tile_width_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    int min_log2_cols = tile_log2(max_tile_width_sb, sb_cols);
    int max_log2_cols = tile_log2(1, std::min(sb_cols, 64));
    int max_log2_rows = tile_log2(1, std::min(sb_rows, 64));
    int min_log2_tiles = std::max(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    mi_col_starts.clear();
    mi_row_starts.clear();
    if (b.f(1)) {  // uniform_tile_spacing_flag
      tile_cols_log2 = min_log2_cols;
      while (tile_cols_log2 < max_log2_cols && b.f(1)) ++tile_cols_log2;
      int w = (sb_cols + (1 << tile_cols_log2) - 1) >> tile_cols_log2;
      for (int s = 0; s < sb_cols; s += w) mi_col_starts.push_back(s << sb_shift);
      tile_cols = (int)mi_col_starts.size();
      int min_log2_rows = std::max(min_log2_tiles - tile_cols_log2, 0);
      tile_rows_log2 = min_log2_rows;
      while (tile_rows_log2 < max_log2_rows && b.f(1)) ++tile_rows_log2;
      int h = (sb_rows + (1 << tile_rows_log2) - 1) >> tile_rows_log2;
      for (int s = 0; s < sb_rows; s += h) mi_row_starts.push_back(s << sb_shift);
      tile_rows = (int)mi_row_starts.size();
    } else {
      int widest = 0;
      for (int s = 0; s < sb_cols;) {
        mi_col_starts.push_back(s << sb_shift);
        int size = b.ns(std::min(sb_cols - s, max_tile_width_sb)) + 1;
        widest = std::max(widest, size);
        s += size;
      }
      tile_cols = (int)mi_col_starts.size();
      tile_cols_log2 = tile_log2(1, tile_cols);
      int area = min_log2_tiles > 0 ? (sb_rows * sb_cols) >> (min_log2_tiles + 1) : sb_rows * sb_cols;
      int max_height = std::max(area / widest, 1);
      for (int s = 0; s < sb_rows;) {
        mi_row_starts.push_back(s << sb_shift);
        s += b.ns(std::min(sb_rows - s, max_height)) + 1;
      }
      tile_rows = (int)mi_row_starts.size();
      tile_rows_log2 = tile_log2(1, tile_rows);
    }
    if (tile_cols > 64 || tile_rows > 64) throw Corrupt{__LINE__};
    mi_col_starts.push_back(mi_cols);
    mi_row_starts.push_back(mi_rows);
    tile_size_bytes = 4;
    if (tile_cols_log2 > 0 || tile_rows_log2 > 0) {
      b.f(tile_rows_log2 + tile_cols_log2);  // context_update_tile_id
      tile_size_bytes = b.f(2) + 1;
    }
  }

  void start_frame() {
    planes = seq.mono ? 1 : 3;
    for (int p = 0; p < planes; ++p) {
      pw[p] = (mi_cols * 4) >> ssx(p);
      ph[p] = (mi_rows * 4) >> ssy(p);
      stride[p] = pw[p] + 64;  // a transform block that starts in the frame may reach 60 samples past it
      frame[p].assign((size_t)stride[p] * (ph[p] + 64), 0);
    }
    size_t n = (size_t)mi_cols * mi_rows;
    y_modes.assign(n, 0); uv_modes.assign(n, 0); mi_sizes.assign(n, 0); skips.assign(n, 0);
    tx_sizes.assign(n, 0); tx_types.assign(n, 0);
    is_inters.assign(n, 0);
    delta_lfs.assign(delta_lf_present ? 4 * n : 0, 0);
    segment_ids.assign(seg_enabled ? n : 0, 0);
    dvs.assign(allow_intrabc ? n : 0, Mv{0, 0});
    above_txfm.assign(mi_cols + 32, 64);
    left_txfm.assign(mi_rows + 32, 64);
    palettes.clear();
    palette_of.assign(allow_screen_content ? n : 0, -1);
    cdef_idx.assign((size_t)((mi_rows + 15) / 16 + 2) * ((mi_cols + 15) / 16 + 2), -1);
    for (int p = 0; p < planes; ++p) {  // count_units_in_frame
      auto count = [&](int n) { return std::max((n + (lr_unit_size[p] >> 1)) / lr_unit_size[p], 1); };
      lr_rows[p] = count((height + ssy(p)) >> ssy(p));
      lr_cols[p] = count((width + ssx(p)) >> ssx(p));
      lr_units[p].assign(lr_type[p] ? (size_t)lr_rows[p] * lr_cols[p] : 0, LrUnit{});
    }
    for (int p = 0; p < 3; ++p) {
      above_level[p].assign(mi_cols + 32, 0); above_dc[p].assign(mi_cols + 32, 0);
      left_level[p].assign(mi_rows + 32, 0); left_dc[p].assign(mi_rows + 32, 0);
    }
    int qctx = base_q_idx <= 20 ? 0 : base_q_idx <= 60 ? 1 : base_q_idx <= 120 ? 2 : 3;
    frame_cdfs.reset(qctx);
    next_tile = 0;
  }

  // ---- tile groups (5.11.1) ----
  void tile_group(const uint8_t* p, int64_t sz) {
    Bits b{p, sz, 0};
    int num_tiles = tile_cols * tile_rows;
    int start = 0, end = num_tiles - 1;
    if (num_tiles > 1 && b.f(1)) {
      int bits = tile_cols_log2 + tile_rows_log2;
      start = b.f(bits);
      end = b.f(bits);
    }
    b.byte_alignment();
    if (start != next_tile || end < start || end >= num_tiles) throw Corrupt{__LINE__};
    int64_t at = b.pos / 8;
    for (int t = start; t <= end; ++t) {
      int64_t size;
      if (t == end) {
        size = sz - at;
      } else {
        if (at + tile_size_bytes > sz) throw Corrupt{__LINE__};
        size = 0;
        for (int i = 0; i < tile_size_bytes; ++i) size |= (int64_t)p[at + i] << (8 * i);
        size += 1;
        at += tile_size_bytes;
        if (size > sz - at) throw Corrupt{__LINE__};
      }
      if (size <= 0) throw Corrupt{__LINE__};
      mi_row_start = mi_row_starts[t / tile_cols];
      mi_row_end = mi_row_starts[t / tile_cols + 1];
      mi_col_start = mi_col_starts[t % tile_cols];
      mi_col_end = mi_col_starts[t % tile_cols + 1];
      cdf = frame_cdfs;
      current_q = base_q_idx;
      for (int i = 0; i < 4; ++i) {  // av1_reset_loop_filter_delta
        if (delta_lf[i]) delta_lf_paths |= kLfTileReset;
        delta_lf[i] = 0;
      }
      for (int q = 0; q < 3; ++q) {  // Wiener_Taps_Mid, Sgrproj_Xqd_Mid
        for (int pass = 0; pass < 2; ++pass) {
          ref_wiener[q][pass][0] = 3; ref_wiener[q][pass][1] = -7; ref_wiener[q][pass][2] = 15;
        }
        ref_sgr[q][0] = -32; ref_sgr[q][1] = 31;
      }
      sym.init(p + at, size, disable_cdf_update);
      decode_tile();
      at += size;
    }
    next_tile = end + 1;
    if (next_tile == num_tiles) decoded = true;
  }

  void decode_tile() {
    for (int p = 0; p < planes; ++p) {
      std::fill(above_level[p].begin(), above_level[p].end(), 0);
      std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
    }
    std::fill(above_txfm.begin(), above_txfm.end(), 64);
    int sb4 = seq.sb128 ? 32 : 16;
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < planes; ++p) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      std::fill(left_txfm.begin(), left_txfm.end(), 64);
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = delta_q_present;
        for (int y = r; y < r + sb4; y += 16)
          for (int x = c; x < c + sb4; x += 16) cdef(y, x) = -1;
        clear_block_decoded(r, c, sb4);
        read_lr(r, c, sb4);
        decode_partition(r, c, seq.sb128 ? B128X128 : B64X64);
        if (sym.overflowed()) throw Corrupt{__LINE__};
      }
    }
    if (!sym.trailing_ok()) throw Corrupt{__LINE__};
  }

  int8_t& cdef(int r, int c) { return cdef_idx[(size_t)(r >> 4) * ((mi_cols + 15) / 16 + 2) + (c >> 4)]; }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int p = 0; p < planes; ++p) {
      int w4 = (mi_col_end - c) >> ssx(p), h4 = (mi_row_end - r) >> ssy(p);
      for (int y = -1; y <= (sb4 >> ssy(p)); ++y)
        for (int x = -1; x <= (sb4 >> ssx(p)); ++x)
          block_decoded(p, y, x) = (y < 0 && x < w4) || (x < 0 && y < h4);
      block_decoded(p, sb4 >> ssy(p), -1) = 0;
    }
  }

  bool inside(int r, int c) const {
    return c >= mi_col_start && c < mi_col_end && r >= mi_row_start && r < mi_row_end;
  }

  static int sub_size(int partition, int bsize) {
    int w = kWide4[bsize], h = kHigh4[bsize];
    switch (partition) {
      case P_NONE: break;
      case P_HORZ: case P_HORZ_A: case P_HORZ_B: h /= 2; break;
      case P_VERT: case P_VERT_A: case P_VERT_B: w /= 2; break;
      case P_SPLIT: w /= 2; h /= 2; break;
      case P_HORZ_4: h /= 4; break;
      case P_VERT_4: w /= 4; break;
    }
    for (int b = 0; b < 22; ++b)
      if (kWide4[b] == w && kHigh4[b] == h) return b;
    return BLOCK_INVALID;
  }

  int partition_symbol(int r, int c, int bsize, bool has_rows, bool has_cols) {
    int bsl = floor_log2(kWide4[bsize]);  // 1 for 8x8 .. 5 for 128x128
    int above = inside(r - 1, c) && floor_log2(kWide4[mi_sizes[(r - 1) * mi_cols + c]]) < bsl;
    int left = inside(r, c - 1) && floor_log2(kHigh4[mi_sizes[r * mi_cols + c - 1]]) < bsl;
    int ctx = left * 2 + above;
    uint16_t* p;
    int n;
    if (bsl == 1) { p = cdf.partition8[ctx]; n = 4; }
    else if (bsl == 5) { p = cdf.partition128[ctx]; n = 8; }
    else { p = cdf.partition16[(bsl - 2) * 4 + ctx]; n = 10; }
    if (has_rows && has_cols) return sym.read(p, n);
    auto prob = [&](int e) { return (int)p[e] - (e > 0 ? (int)p[e - 1] : 0); };
    int psum;
    if (has_cols) {  // the bottom half is outside: split_or_horz
      psum = prob(P_VERT) + prob(P_SPLIT) + prob(P_HORZ_A) + prob(P_VERT_A) + prob(P_VERT_B);
      if (bsize != B128X128) psum += prob(P_VERT_4);
    } else {  // split_or_vert
      psum = prob(P_HORZ) + prob(P_SPLIT) + prob(P_HORZ_A) + prob(P_HORZ_B) + prob(P_VERT_A);
      if (bsize != B128X128) psum += prob(P_HORZ_4);
    }
    uint16_t bin[3] = {(uint16_t)((1 << 15) - psum), 1 << 15, 0};
    int split = sym.read_fixed(bin, 2);
    return split ? P_SPLIT : has_cols ? P_HORZ : P_VERT;
  }

  void decode_partition(int r, int c, int bsize) {
    if (r >= mi_rows || c >= mi_cols) return;
    int num4 = kWide4[bsize], half = num4 >> 1, quarter = half >> 1;
    bool has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
    int partition;
    if (bsize < B8X8) partition = P_NONE;
    else if (has_rows && has_cols) partition = partition_symbol(r, c, bsize, true, true);
    else if (has_cols || has_rows) partition = partition_symbol(r, c, bsize, has_rows, has_cols);
    else partition = P_SPLIT;
    int sub = sub_size(partition, bsize), split = sub_size(P_SPLIT, bsize);
    // libaom: a partition whose chroma block the subsampling does not allow
    if (planes > 1 && kSubsampled[sub][seq.ssx][seq.ssy] == BLOCK_INVALID) throw Corrupt{__LINE__};
    switch (partition) {
      case P_NONE: decode_block(r, c, sub, partition); break;
      case P_HORZ:
        decode_block(r, c, sub, partition);
        if (has_rows) decode_block(r + half, c, sub, partition);
        break;
      case P_VERT:
        decode_block(r, c, sub, partition);
        if (has_cols) decode_block(r, c + half, sub, partition);
        break;
      case P_SPLIT:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case P_HORZ_A:
        decode_block(r, c, split, partition);
        decode_block(r, c + half, split, partition);
        decode_block(r + half, c, sub, partition);
        break;
      case P_HORZ_B:
        decode_block(r, c, sub, partition);
        decode_block(r + half, c, split, partition);
        decode_block(r + half, c + half, split, partition);
        break;
      case P_VERT_A:
        decode_block(r, c, split, partition);
        decode_block(r + half, c, split, partition);
        decode_block(r, c + half, sub, partition);
        break;
      case P_VERT_B:
        decode_block(r, c, sub, partition);
        decode_block(r, c + half, split, partition);
        decode_block(r + half, c + half, split, partition);
        break;
      case P_HORZ_4:
        for (int i = 0; i < 4; ++i)
          if (i < 3 || r + quarter * 3 < mi_rows) decode_block(r + quarter * i, c, sub, partition);
        break;
      case P_VERT_4:
        for (int i = 0; i < 4; ++i)
          if (i < 3 || c + quarter * 3 < mi_cols) decode_block(r, c + quarter * i, sub, partition);
        break;
    }
  }

  // ---- a block (5.11.5) ----
  void decode_block(int r, int c, int bsize, int part) {
    mi_row = r; mi_col = c; mi_size = bsize; partition = part;
    int bw4 = kWide4[bsize], bh4 = kHigh4[bsize];
    has_chroma = planes > 1 && !(seq.ssx && bw4 == 1 && (c & 1) == 0) && !(seq.ssy && bh4 == 1 && (r & 1) == 0);
    avail_u = inside(r - 1, c);
    avail_l = inside(r, c - 1);
    avail_u_chroma = avail_u;
    avail_l_chroma = avail_l;
    if (has_chroma) {
      if (seq.ssy && bh4 == 1) avail_u_chroma = inside(r - 2, c);
      if (seq.ssx && bw4 == 1) avail_l_chroma = inside(r, c - 2);
    } else {
      avail_u_chroma = avail_l_chroma = 0;
    }
    intra_frame_mode_info();
    palette_tokens();
    if (use_intrabc) {
      read_block_tx_size();
    } else {
      read_tx_size();
      set_txfm_ctxs(tx_w(tx_size), tx_h(tx_size));
    }
    if (skip) {
      for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
        for (int i = c >> ssx(p); i < (c + bw4) >> ssx(p); ++i) { above_level[p][i] = 0; above_dc[p][i] = 0; }
        for (int i = r >> ssy(p); i < (r + bh4) >> ssy(p); ++i) { left_level[p][i] = 0; left_dc[p][i] = 0; }
      }
    }
    for (int y = 0; y < bh4; ++y) {
      if (r + y >= mi_rows) break;
      for (int x = 0; x < bw4; ++x) {
        if (c + x >= mi_cols) break;
        int64_t k = (int64_t)(r + y) * mi_cols + c + x;
        y_modes[k] = (uint8_t)y_mode; mi_sizes[k] = (uint8_t)bsize;
        if (has_chroma) uv_modes[k] = (uint8_t)uv_mode;
        skips[k] = (uint8_t)skip; tx_sizes[k] = (uint8_t)(use_intrabc ? inter_tx[y][x] : tx_size);
        is_inters[k] = (uint8_t)use_intrabc;
        if (use_intrabc) dvs[k] = dv;
        if (delta_lf_present)
          for (int i = 0; i < 4; ++i) delta_lfs[4 * k + i] = (int8_t)delta_lf[i];
        if (seg_enabled) segment_ids[k] = (uint8_t)segment_id;
        if (palette_size[0] || palette_size[1]) palette_of[k] = (int32_t)palettes.size();
      }
    }
    if (palette_size[0] || palette_size[1]) {
      Palette pal{{(uint8_t)palette_size[0], (uint8_t)palette_size[1]}, {}};
      std::memcpy(pal.colors, palette_colors, sizeof pal.colors);
      palettes.push_back(pal);
    }
    if (delta_lf_present && (delta_lf[0] || delta_lf[1] || delta_lf[2] || delta_lf[3])) ++delta_lf_blocks;
    if (use_intrabc) predict_intrabc();
    residual();
  }

  // 5.11.7: the segment id, read before skip where a segment has a feature from SEG_LVL_REF_FRAME on (skip is then 1
  // without a symbol under SEG_LVL_SKIP), after it otherwise
  void intra_frame_mode_info() {
    segment_id = 0;
    if (seg_enabled && seg_preskip) {
      read_segment_id(false);
      seg_paths |= kSegPreskip;
    }
    if (seg_enabled && seg_feature(segment_id, kSegLvlSkip)) {
      skip = 1;
      seg_paths |= kSegSkip;
    } else {
      int ctx = (avail_u ? skips[(mi_row - 1) * mi_cols + mi_col] : 0) +
                (avail_l ? skips[mi_row * mi_cols + mi_col - 1] : 0);
      skip = sym.read(cdf.skip[ctx], 2);
    }
    if (seg_enabled && !seg_preskip) read_segment_id(skip);
    lossless = seg_lossless[segment_id];
    if (seg_enabled) {
      seg_ids_used |= 1 << segment_id;
      if (lossless && !coded_lossless) seg_paths |= kSegLosslessBlock;
    }
    read_cdef();
    read_delta_qindex();
    read_delta_lf();
    read_deltas = 0;
    palette_size[0] = palette_size[1] = 0;
    use_filter_intra = 0;
    use_intrabc = allow_intrabc ? sym.read(cdf.intrabc, 2) : 0;
    if (use_intrabc) {  // read_intrabc_info: the block keeps DC_PRED as its modes, which later blocks' contexts read
      y_mode = uv_mode = DC_PRED;
      angle_y = angle_uv = cfl_alpha_u = cfl_alpha_v = 0;
      read_dv();
      return;
    }
    int above = kIntraModeContext[avail_u ? y_modes[(mi_row - 1) * mi_cols + mi_col] : 0];
    int left = kIntraModeContext[avail_l ? y_modes[mi_row * mi_cols + mi_col - 1] : 0];
    y_mode = sym.read(cdf.kf_y[above * 5 + left], 13);
    angle_y = angle_uv = 0;
    bool angle_delta = mi_size >= B8X8;
    if (angle_delta && y_mode >= V_PRED && y_mode <= D67_PRED)
      angle_y = sym.read(cdf.angle[y_mode - V_PRED], 7) - 3;
    uv_mode = DC_PRED;
    cfl_alpha_u = cfl_alpha_v = 0;
    if (has_chroma) {
      bool cfl_allowed = lossless ? kSubsampled[mi_size][seq.ssx][seq.ssy] == B4X4
                                  : std::max(kWide4[mi_size], kHigh4[mi_size]) <= 8;
      uv_mode = cfl_allowed ? sym.read(cdf.uv_cfl[y_mode], 14) : sym.read(cdf.uv_no_cfl[y_mode], 13);
      if (uv_mode == UV_CFL_PRED) {
        int signs = sym.read(cdf.cfl_sign, 8);
        int sign_u = (signs + 1) / 3, sign_v = (signs + 1) % 3;
        if (sign_u) {
          int a = sym.read(cdf.cfl_alpha[(sign_u - 1) * 3 + sign_v], 16) + 1;
          cfl_alpha_u = sign_u == 1 ? -a : a;
        }
        if (sign_v) {
          int a = sym.read(cdf.cfl_alpha[(sign_v - 1) * 3 + sign_u], 16) + 1;
          cfl_alpha_v = sign_v == 1 ? -a : a;
        }
      }
      if (angle_delta && uv_mode >= V_PRED && uv_mode <= D67_PRED)
        angle_uv = sym.read(cdf.angle[uv_mode - V_PRED], 7) - 3;
    }
    if (allow_screen_content && mi_size >= B8X8 && kWide4[mi_size] <= 16 && kHigh4[mi_size] <= 16)
      palette_mode_info();
    if (seq.filter_intra && y_mode == DC_PRED && !palette_size[0] && std::max(kWide4[mi_size], kHigh4[mi_size]) <= 8) {
      use_filter_intra = sym.read(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) filter_intra_mode = sym.read(cdf.filter_intra_mode, 5);
    }
  }

  // the paths a frame's segmentation took (meta[21]): the id read before skip, skip set by SEG_LVL_SKIP, the id
  // predicted without a symbol (a skipped block), a neighbour left out at a tile edge inside the frame, a lossless
  // block in a frame that is not coded lossless, a quantizer of CurrentQIndex plus ALT_Q that base_q_idx plus ALT_Q
  // is not, an edge filtered at a level its segment raised from a frame level of 0
  enum {
    kSegPreskip = 1, kSegSkip = 2, kSegPredicted = 4, kSegTileEdge = 8, kSegLosslessBlock = 16, kSegDeltaQ = 32,
    kSegLfRaised = 64
  };

  // 5.11.9 read_segment_id with libaom's av1_get_spatial_seg_pred: the prediction and context from the upper-left,
  // upper and left ids within the tile; a skipped block (read after skip) takes the prediction, another codes the id
  // against it (neg_deinterleave). libaom fails on an id past LastActiveSegId where the specification clips it.
  void read_segment_id(int skipped) {
    auto id = [&](int r, int c) { return (int)segment_ids[(int64_t)r * mi_cols + c]; };
    const int ul = avail_u && avail_l ? id(mi_row - 1, mi_col - 1) : -1;
    const int u = avail_u ? id(mi_row - 1, mi_col) : -1, l = avail_l ? id(mi_row, mi_col - 1) : -1;
    if ((!avail_u && mi_row > 0) || (!avail_l && mi_col > 0)) seg_paths |= kSegTileEdge;
    const int ctx = ul < 0 ? 0 : ul == u && ul == l ? 2 : ul == u || ul == l || u == l ? 1 : 0;
    const int pred = u == -1 ? (l == -1 ? 0 : l) : l == -1 ? u : ul == u ? u : l;
    if (skipped) {
      segment_id = pred;
      seg_paths |= kSegPredicted;
      return;
    }
    const int v = neg_deinterleave(sym.read(cdf.spatial_seg[ctx], 8), pred, last_active_seg + 1);
    if (v < 0 || v > last_active_seg) throw Corrupt{__LINE__};  // "Corrupted segment_ids"
    segment_id = v;
  }

  // libaom's av1_neg_deinterleave: the id that ``diff`` codes against the prediction ``ref`` of ``max`` ids (a
  // symbol of ``max`` or more gives one outside them)
  static int neg_deinterleave(int diff, int ref, int max) {
    if (!ref) return diff;
    if (ref >= max - 1) return max - diff - 1;
    const int near = 2 * ref < max ? 2 * ref : 2 * (max - ref - 1);
    if (diff <= near) return (diff & 1) ? ref + ((diff + 1) >> 1) : ref - (diff >> 1);
    return 2 * ref < max ? diff : max - (diff + 1);
  }

  // ---- intra block copy (5.11.23-26, 7.10.2, 7.11.3; libaom's read_intrabc_info) ----
  // the paths a frame's blocks took (meta[17])
  enum {
    kPathHalfX = 1, kPathHalfY = 2, kPathVarTx1 = 4, kPathVarTx2 = 8, kPathSet1 = 16, kPathSet2 = 32, kPathSet3 = 64,
    kPathDefaultAbove = 128, kPathDefaultLeft = 256
  };
  struct Candidate {
    Mv mv;
    int weight;
  };

  // add_ref_mv_candidate: the block at (r, c), if it copies, adds its DV or the weight to an equal one
  void add_candidate(int r, int c, int weight, Candidate* stack, int* n) const {
    const int64_t k = (int64_t)r * mi_cols + c;
    if (!is_inters[k]) return;
    for (int i = 0; i < *n; ++i)
      if (stack[i].mv == dvs[k]) {
        stack[i].weight += weight;
        return;
      }
    if (*n < 8) stack[(*n)++] = Candidate{dvs[k], weight};
  }

  // scan_row_mbmi (rows above, delta < 0) and scan_col_mbmi (columns left): the blocks along the block's side at
  // ``delta``, weighted by their overlap; a neighbour as wide (high) as the block takes the rows (columns) up to
  // ``max_delta`` in one weight, and the later scans skip them
  void scan_line(bool row, int delta, int max_delta, int* processed, Candidate* stack, int* n) const {
    const int along = row ? kWide4[mi_size] : kHigh4[mi_size];
    const int end = std::min(std::min(along, row ? mi_cols - mi_col : mi_rows - mi_row), 16);
    int offset = 0;
    if (std::abs(delta) > 1) offset = 1 - (((row ? mi_col : mi_row) & 1) && along < 2);
    for (int i = 0; i < end;) {
      const int r = row ? mi_row + delta : mi_row + offset + i, c = row ? mi_col + offset + i : mi_col + delta;
      const int cand = mi_sizes[(int64_t)r * mi_cols + c];
      const int cand_along = row ? kWide4[cand] : kHigh4[cand], cand_across = row ? kHigh4[cand] : kWide4[cand];
      int len = std::min(along, cand_along);
      if (along >= 16) len = std::max(4, len);
      else if (std::abs(delta) > 1) len = std::max(len, 2);
      int weight = 2;
      if (along >= 2 && along <= cand_along) {
        const int inc = std::min(-max_delta + delta + 1, cand_across);
        weight = std::max(weight, inc);
        *processed = inc - delta - 1;
      }
      add_candidate(r, c, len * weight, stack, n);
      i += len;
    }
  }

  // has_top_right (libaom's mvref_common.c): whether the block above and to the right is decoded
  bool dv_has_top_right() const {
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size], sb = seq.sb128 ? 32 : 16;
    const int mask_row = mi_row & (sb - 1), mask_col = mi_col & (sb - 1);
    int bs = std::max(bw4, bh4);
    if (bs > 16) return false;
    bool has_tr = !((mask_row & bs) && (mask_col & bs));
    for (; bs < sb; bs <<= 1) {
      if (!(mask_col & bs)) break;
      if ((mask_col & (2 * bs)) && (mask_row & (2 * bs))) {
        has_tr = false;
        break;
      }
    }
    if (bw4 < bh4 && ((mi_col + bw4) & (bh4 - 1))) has_tr = true;  // not the last of a vertical split
    if (bw4 > bh4 && (mi_row & (bw4 - 1))) has_tr = false;         // not the first of a horizontal split
    if (partition == P_VERT_A && bw4 == bh4 && (mask_row & bs)) has_tr = false;
    return has_tr;
  }

  // setup_ref_mv_list for INTRA_FRAME: the spatial candidates (the nearest row and column, the top-right and
  // top-left blocks, then two more rows and columns out), ranked by weight, the nearest first, each clamped
  int dv_stack(Candidate* stack) const {
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size];
    const int row_adj = bh4 < 2 && (mi_row & 1), col_adj = bw4 < 2 && (mi_col & 1);
    int max_row = 0, max_col = 0, done_rows = 0, done_cols = 0, n = 0;
    if (avail_u) max_row = std::max((bh4 < 2 ? -4 : -6) + row_adj, mi_row_start - mi_row);
    if (avail_l) max_col = std::max((bw4 < 2 ? -4 : -6) + col_adj, mi_col_start - mi_col);
    if (max_row) scan_line(true, -1, max_row, &done_rows, stack, &n);
    if (max_col) scan_line(false, -1, max_col, &done_cols, stack, &n);
    if (dv_has_top_right() && inside(mi_row - 1, mi_col + bw4)) add_candidate(mi_row - 1, mi_col + bw4, 4, stack, &n);
    const int nearest = n;
    for (int i = 0; i < nearest; ++i) stack[i].weight += 640;  // REF_CAT_LEVEL
    if (inside(mi_row - 1, mi_col - 1)) add_candidate(mi_row - 1, mi_col - 1, 4, stack, &n);
    for (int idx = 2; idx <= 3; ++idx) {
      const int dr = -(idx << 1) + 1 + row_adj, dc = -(idx << 1) + 1 + col_adj;
      if (std::abs(dr) <= std::abs(max_row) && std::abs(dr) > done_rows)
        scan_line(true, dr, max_row, &done_rows, stack, &n);
      if (std::abs(dc) <= std::abs(max_col) && std::abs(dc) > done_cols)
        scan_line(false, dc, max_col, &done_cols, stack, &n);
    }
    auto heavier = [](const Candidate& a, const Candidate& b) { return a.weight > b.weight; };
    std::stable_sort(stack, stack + nearest, heavier);
    std::stable_sort(stack + nearest, stack + n, heavier);
    // clamp_mv_ref: at most the block's size and 16 pixels past the frame's edges
    const int bw = bw4 * 4, bh = bh4 * 4;
    for (int i = 0; i < n; ++i) {
      Mv& m = stack[i].mv;
      m.col = (int16_t)std::min(std::max((int)m.col, -(mi_col * 32) - bw * 8 - 128),
                                (mi_cols - bw4 - mi_col) * 32 + bw * 8 + 128);
      m.row = (int16_t)std::min(std::max((int)m.row, -(mi_row * 32) - bh * 8 - 128),
                                (mi_rows - bh4 - mi_row) * 32 + bh * 8 + 128);
    }
    return n;
  }

  // read_mv_component at whole pixels (force_integer_mv): sign, class, then class 0's bit or the class's bits
  int read_mv_component(int comp) {
    const int sign = sym.read(cdf.mv_sign[comp], 2), cls = sym.read(cdf.mv_class[comp], 11);
    int mag, d = 0;
    if (cls == 0) {
      d = sym.read(cdf.mv_class0[comp], 2);
      mag = 0;
    } else {
      for (int i = 0; i < cls; ++i) d |= sym.read(cdf.mv_bits[comp][i], 2) << i;
      mag = 2 << (cls + 2);
    }
    mag += ((d << 3) | 7) + 1;
    return sign ? -mag : mag;
  }

  // the block's DV: the first non-zero of the stack's two best (else the default, a superblock up or, in the tile's
  // first superblock row, a superblock and 256 pixels left) plus the coded difference; a DV libaom rejects marks the
  // frame corrupt
  void read_dv() {
    Candidate stack[8];
    const int n = dv_stack(stack);
    ++intrabc_blocks;
    intrabc_stacked += n > 0;
    const Mv zero{0, 0};
    Mv ref = n > 0 ? stack[0].mv : zero;
    if (ref == zero && n > 1) ref = stack[1].mv;
    if (ref == zero) {  // av1_find_ref_dv
      const int sb4 = seq.sb128 ? 32 : 16;
      if (mi_row - sb4 < mi_row_start) {
        ref = Mv{0, (int16_t)(-(4 * sb4 + 256) * 8)};
        intrabc_paths |= kPathDefaultLeft;
      } else {
        ref = Mv{(int16_t)(-4 * sb4 * 8), 0};
        intrabc_paths |= kPathDefaultAbove;
      }
    }
    if ((ref.row & 7) || (ref.col & 7)) throw Corrupt{__LINE__};
    const int joint = sym.read(cdf.mv_joint, 4);
    const int row = ref.row + (joint >= 2 ? read_mv_component(0) : 0);
    const int col = ref.col + ((joint & 1) ? read_mv_component(1) : 0);
    if (!dv_valid(row, col)) throw Corrupt{__LINE__};
    dv = Mv{(int16_t)row, (int16_t)col};
  }

  // is_mv_valid and av1_is_dv_valid: whole pixels; the source inside the tile (a sub-8x8 block's chroma, which
  // reaches 4 luma pixels further up or left, too) and in a superblock coded at least 256 pixels (INTRABC_DELAY_SB64
  // 64x64s) earlier, the rows above behind a wavefront
  bool dv_valid(int row, int col) const {
    if (row <= -(1 << 14) || row >= (1 << 14) || col <= -(1 << 14) || col >= (1 << 14)) return false;
    if ((row & 7) || (col & 7)) return false;
    const int bw = kWide4[mi_size] * 4, bh = kHigh4[mi_size] * 4;
    const int top = mi_row * 32 + row, left = mi_col * 32 + col, bottom = (mi_row * 4 + bh) * 8 + row,
              right = (mi_col * 4 + bw) * 8 + col;
    if (top < mi_row_start * 32 || left < mi_col_start * 32 || bottom > mi_row_end * 32 || right > mi_col_end * 32)
      return false;
    if (has_chroma) {
      if (bw < 8 && seq.ssx && left < mi_col_start * 32 + 32) return false;
      if (bh < 8 && seq.ssy && top < mi_row_start * 32 + 32) return false;
    }
    const int sb_log2 = seq.sb128 ? 5 : 4, sb_size = 4 << sb_log2;
    const int active_sb_row = mi_row >> sb_log2, active_sb64_col = (mi_col * 4) >> 6;
    const int src_sb_row = ((bottom >> 3) - 1) / sb_size, src_sb64_col = ((right >> 3) - 1) >> 6;
    const int per_row = ((mi_col_end - mi_col_start - 1) >> 4) + 1;
    if (src_sb_row * per_row + src_sb64_col >= active_sb_row * per_row + active_sb64_col - 4) return false;
    const int wavefront = (1 + 4 + (sb_size > 64)) * (active_sb_row - src_sb_row);
    return !(src_sb_row > active_sb_row || src_sb64_col >= active_sb64_col - 4 + wavefront);
  }

  // The block's prediction in each plane, copied from the frame as decoded so far (no filter has run): luma at whole
  // pixels, subsampled chroma with the BILINEAR filter at a half pixel where the DV is odd. A chroma block at least 4
  // wide and high covers a sub-8x8 block's neighbours too, from this block's DV. Both roundings of
  // block_inter_prediction divide exactly, so a half pixel is the rounded mean of its 2 or 4 samples.
  void predict_intrabc() {
    for (int plane = 0; plane < 1 + 2 * has_chroma; ++plane) {
      const int sx = ssx(plane), sy = ssy(plane);
      const int bw = kWide4[mi_size] * 4, bh = kHigh4[mi_size] * 4;
      const int w = std::max(4, bw >> sx), h = std::max(4, bh >> sy);
      const int bx = (mi_col * 4 - (bw == 4 && sx ? 4 : 0)) >> sx, by = (mi_row * 4 - (bh == 4 && sy ? 4 : 0)) >> sy;
      const int mx = bx * 16 + dv.col * (2 >> sx), my = by * 16 + dv.row * (2 >> sy);  // 1/16 samples
      const int x0 = mx >> 4, y0 = my >> 4, fx = (mx & 15) != 0, fy = (my & 15) != 0;
      intrabc_paths |= (fx ? kPathHalfX : 0) | (fy ? kPathHalfY : 0);
      // av1_is_dv_valid keeps the source in the tile; a source past the plane would be a fault of that rule
      if (x0 < 0 || y0 < 0 || x0 + w + fx > pw[plane] || y0 + h + fy > ph[plane]) throw Corrupt{__LINE__};
      const int rows = std::min(h, ph[plane] - by), cols = std::min(w, pw[plane] - bx);
      for (int i = 0; i < rows; ++i) {
        const uint16_t* a = &px(plane, y0 + i, x0);
        const uint16_t* b = a + (fy ? stride[plane] : 0);
        uint16_t* o = &px(plane, by + i, bx);
        for (int j = 0; j < cols; ++j) {
          if (fx && fy) o[j] = (uint16_t)((a[j] + a[j + 1] + b[j] + b[j + 1] + 2) >> 2);
          else if (fx) o[j] = (uint16_t)((a[j] + a[j + 1] + 1) >> 1);
          else if (fy) o[j] = (uint16_t)((a[j] + b[j] + 1) >> 1);
          else o[j] = a[j];
        }
      }
    }
  }

  int literal(int n) {
    int x = 0;
    for (int i = 0; i < n; ++i) x = 2 * x + sym.boolean();
    return x;
  }

  int ns(int n) {  // NS(n): ns(n) in bools
    const int w = floor_log2((uint32_t)n) + 1, m = (1 << w) - n, v = literal(w - 1);
    return v < m ? v : (v << 1) - m + literal(1);
  }

  static int ceil_log2(int x) { return x < 2 ? 0 : floor_log2((uint32_t)(x - 1)) + 1; }

  // ---- palette mode (5.11.46, 5.11.49, 7.11.4) ----
  // the palette of the block that covers the 4x4 unit (r, c), or none
  const Palette* palette_at(int r, int c) const {
    const int32_t k = palette_of[(int64_t)r * mi_cols + c];
    return k < 0 ? nullptr : &palettes[k];
  }

  void palette_mode_info() {
    const int bsize_ctx = floor_log2(kWide4[mi_size]) + floor_log2(kHigh4[mi_size]) - 2;
    if (y_mode == DC_PRED) {
      const Palette* above = avail_u ? palette_at(mi_row - 1, mi_col) : nullptr;
      const Palette* left = avail_l ? palette_at(mi_row, mi_col - 1) : nullptr;
      const int ctx = (above && above->n[0]) + (left && left->n[0]);
      if (sym.read(cdf.palette_y_mode[bsize_ctx][ctx], 2)) {
        palette_size[0] = sym.read(cdf.palette_y_size[bsize_ctx], 7) + 2;
        palette_y_sizes |= 1 << palette_size[0];
        read_palette_colors(0);
      }
    }
    if (has_chroma && uv_mode == DC_PRED && sym.read(cdf.palette_uv_mode[palette_size[0] > 0], 2)) {
      palette_size[1] = sym.read(cdf.palette_uv_size[bsize_ctx], 7) + 2;
      palette_uv_sizes |= 1 << palette_size[1];
      read_palette_colors(1);
      const int n = palette_size[1], bd = seq.bit_depth;
      uint16_t* v = palette_colors[2];
      if (literal(1)) {  // delta_encode_palette_colors_v: signed deltas, wrapping around 1 << BitDepth
        ++palette_v_deltas;
        const int bits = bd - 4 + literal(2);
        v[0] = (uint16_t)literal(bd);
        for (int i = 1; i < n; ++i) {
          int delta = literal(bits);
          if (delta && literal(1)) delta = -delta;
          int val = v[i - 1] + delta;
          if (val < 0) val += 1 << bd;
          if (val >= 1 << bd) val -= 1 << bd;
          v[i] = (uint16_t)val;
        }
      } else {
        for (int i = 0; i < n; ++i) v[i] = (uint16_t)literal(bd);
      }
    }
  }

  // get_palette_cache: the ascending, distinct colours of the above (within the same 64-row band) and left blocks'
  // palettes of Y (plane 0) or U (plane 1)
  int palette_cache(int plane, uint16_t* cache) const {
    const Palette* above = (mi_row * 4) % 64 && avail_u ? palette_at(mi_row - 1, mi_col) : nullptr;
    const Palette* left = avail_l ? palette_at(mi_row, mi_col - 1) : nullptr;
    const int an = above ? above->n[plane] : 0, ln = left ? left->n[plane] : 0;
    int ai = 0, li = 0, n = 0;
    auto put = [&](uint16_t v) {
      if (n == 0 || cache[n - 1] != v) cache[n++] = v;
    };
    while (ai < an && li < ln) {
      const uint16_t a = above->colors[plane][ai], l = left->colors[plane][li];
      if (l < a) {
        put(l);
        ++li;
      } else {
        put(a);
        ++ai;
        li += l == a;
      }
    }
    while (ai < an) put(above->colors[plane][ai++]);
    while (li < ln) put(left->colors[plane][li++]);
    return n;
  }

  // the colours of Y (plane 0) or U (plane 1): those of the cache the block takes, then a literal and ascending
  // deltas (at least 1 for Y) in a width that shrinks with the room left above them; sorted, as the two runs merge
  void read_palette_colors(int plane) {
    const int n = palette_size[plane], bd = seq.bit_depth, y = plane == 0;
    uint16_t cache[16], *out = palette_colors[plane];
    const int cache_n = palette_cache(plane, cache);
    int idx = 0;
    for (int i = 0; i < cache_n && idx < n; ++i)
      if (literal(1)) out[idx++] = cache[i];
    palette_cached += idx;
    if (idx == n) return;
    out[idx++] = (uint16_t)literal(bd);
    if (idx < n) {
      int bits = bd - 3 + literal(2);
      for (; idx < n; ++idx) {
        out[idx] = (uint16_t)std::min(out[idx - 1] + literal(bits) + y, (1 << bd) - 1);
        bits = std::min(bits, ceil_log2((1 << bd) - out[idx] - y));
      }
    }
    std::sort(out, out + n);
  }

  // palette_tokens: the colour index maps of Y and UV over the block's visible part, wavefront by wavefront, then
  // extended to the whole block; a chroma map under 4 samples wide or high is 2 wider or higher
  void palette_tokens() {
    const int bw = kWide4[mi_size] * 4, bh = kHigh4[mi_size] * 4;
    const int on_w = std::min(bw, (mi_cols - mi_col) * 4), on_h = std::min(bh, (mi_rows - mi_row) * 4);
    for (int k = 0; k < 2; ++k) {
      const int n = palette_size[k];
      if (!n) continue;
      int w = bw >> ssx(k), h = bh >> ssy(k), ow = on_w >> ssx(k), oh = on_h >> ssy(k);
      if (w < 4) { w += 2; ow += 2; }
      if (h < 4) { h += 2; oh += 2; }
      uint8_t* m = color_map[k];
      map_w[k] = w;
      m[0] = (uint8_t)ns(n);
      for (int i = 1; i < oh + ow - 1; ++i) {
        for (int j = std::min(i, ow - 1); j >= std::max(0, i - oh + 1); --j) {
          int order[8];
          const int ctx = color_context(m, w, i - j, j, n, order);
          m[(i - j) * w + j] = (uint8_t)order[sym.read(cdf.palette_color[k][n - 2][ctx], n)];
        }
      }
      for (int i = 0; i < oh; ++i) std::memset(m + i * w + ow, m[i * w + ow - 1], w - ow);
      for (int i = oh; i < h; ++i) std::memcpy(m + i * w, m + (oh - 1) * w, w);
    }
  }

  // get_palette_color_context: the colours of the left, above-left and above indices ranked by their weights (2, 1,
  // 2) into ``order``, and the context their ranked scores hash to (multipliers 1, 2, 2)
  static int color_context(const uint8_t* m, int stride, int r, int c, int n, int* order) {
    static const int kHashToCtx[9] = {-1, -1, 0, -1, -1, 4, 3, 2, 1};
    int scores[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 8; ++i) order[i] = i;
    if (c > 0) scores[m[r * stride + c - 1]] += 2;
    if (r > 0 && c > 0) scores[m[(r - 1) * stride + c - 1]] += 1;
    if (r > 0) scores[m[(r - 1) * stride + c]] += 2;
    for (int i = 0; i < 3; ++i) {
      int best = i;
      for (int j = i + 1; j < n; ++j)
        if (scores[j] > scores[best]) best = j;
      const int score = scores[best], color = order[best];
      for (int k = best; k > i; --k) {
        scores[k] = scores[k - 1];
        order[k] = order[k - 1];
      }
      scores[i] = score;
      order[i] = color;
    }
    return kHashToCtx[scores[0] + 2 * scores[1] + 2 * scores[2]];
  }

  void read_cdef() {  // the CDEF index of each 64x64, read where its first coded block is
    if (skip || coded_lossless || allow_intrabc || !seq.cdef) return;
    int r = mi_row & ~15, c = mi_col & ~15;
    if (cdef(r, c) == -1) {
      int v = literal(cdef_bits);
      for (int y = r; y < r + kHigh4[mi_size]; y += 16)
        for (int x = c; x < c + kWide4[mi_size]; x += 16) cdef(y, x) = (int8_t)v;
      cdef(r, c) = (int8_t)v;
    }
  }

  // 5.11.57: the restoration units whose top-left corner lies in the superblock at (r, c)
  void read_lr(int r, int c, int sb4) {
    for (int p = 0; p < planes; ++p) {
      if (!lr_type[p]) continue;
      const int size = lr_unit_size[p], mx = 4 >> ssx(p), my = 4 >> ssy(p);
      const int row0 = (r * my + size - 1) / size, row1 = std::min(lr_rows[p], ((r + sb4) * my + size - 1) / size);
      const int col0 = (c * mx + size - 1) / size, col1 = std::min(lr_cols[p], ((c + sb4) * mx + size - 1) / size);
      for (int ur = row0; ur < row1; ++ur)
        for (int uc = col0; uc < col1; ++uc) read_lr_unit(p, lr_units[p][(size_t)ur * lr_cols[p] + uc]);
    }
  }

  // 5.11.58
  void read_lr_unit(int plane, LrUnit& u) {
    static const int kWienerMin[3] = {-5, -23, -17}, kWienerMax[3] = {10, 8, 46}, kWienerK[3] = {1, 2, 3};
    static const int kXqdMin[2] = {-96, -32}, kXqdMax[2] = {31, 95};
    if (lr_type[plane] == kRestoreSwitchable) u.type = (uint8_t)sym.read(cdf.restoration_type, 3);
    else if (lr_type[plane] == kRestoreWiener) u.type = sym.read(cdf.use_wiener, 2) ? kRestoreWiener : kRestoreNone;
    else u.type = sym.read(cdf.use_sgrproj, 2) ? kRestoreSgrproj : kRestoreNone;
    if (u.type == kRestoreWiener) {
      for (int pass = 0; pass < 2; ++pass) {
        u.wiener[pass][0] = 0;
        for (int j = plane ? 1 : 0; j < 3; ++j) {
          const int v = subexp_with_ref(kWienerMin[j], kWienerMax[j] + 1, kWienerK[j], ref_wiener[plane][pass][j]);
          u.wiener[pass][j] = (int8_t)v;
          ref_wiener[plane][pass][j] = v;
        }
      }
    } else if (u.type == kRestoreSgrproj) {
      u.set = (uint8_t)literal(4);
      for (int i = 0; i < 2; ++i) {
        int v = 0;
        if (av1t::kSgrParams[u.set][i]) v = subexp_with_ref(kXqdMin[i], kXqdMax[i] + 1, 4, ref_sgr[plane][i]);
        else if (i == 1) v = std::min(kXqdMax[1], std::max(kXqdMin[1], (1 << 7) - ref_sgr[plane][0]));
        u.xqd[i] = (int16_t)v;
        ref_sgr[plane][i] = v;
      }
    }
  }

  // decode_signed_subexp_with_ref_bool: a value of [low, high) coded against the reference r
  int subexp_with_ref(int low, int high, int k, int r) {
    const int mx = high - low;
    r -= low;
    int v, i = 0, mk = 0;
    while (true) {  // decode_subexp_bool
      const int b2 = i ? k + i - 1 : k, a = 1 << b2;
      if (mx <= mk + 3 * a) {  // NS(mx - mk)
        const int n = mx - mk, w = floor_log2((uint32_t)n) + 1, m = (1 << w) - n;
        v = literal(w - 1);
        if (v >= m) v = (v << 1) - m + literal(1);
        v += mk;
        break;
      }
      if (!literal(1)) {
        v = literal(b2) + mk;
        break;
      }
      ++i;
      mk += a;
    }
    auto inverse_recenter = [](int rr, int vv) {
      return vv > 2 * rr ? vv : (vv & 1) ? rr - ((vv + 1) >> 1) : rr + (vv >> 1);
    };
    return low + ((r << 1) <= mx ? inverse_recenter(r, v) : mx - 1 - inverse_recenter(mx - 1 - r, v));
  }

  int delta_value(uint16_t* cdf4) {  // delta_q_abs or delta_lf_abs, its extra bits and sign
    int abs = sym.read(cdf4, 4);
    if (abs == 3) {
      int n = literal(3) + 1;
      abs = literal(n) + (1 << n) + 1;
    }
    if (abs && literal(1)) return -abs;
    return abs;
  }

  void read_delta_qindex() {
    if ((mi_size == (seq.sb128 ? B128X128 : B64X64) && skip) || !read_deltas) return;
    int d = delta_value(cdf.delta_q);
    if (d) current_q = std::min(255, std::max(1, current_q + (d << delta_q_res)));
  }

  // the paths a frame's delta LF took (meta[19]): deltas per plane and direction, a multiplier above 1, a running
  // delta clamped to +-MAX_LOOP_FILTER, an edge filtered in a pass whose frame level is 0, a tile that reset deltas
  // that were not 0
  enum { kLfMulti = 1, kLfRes = 2, kLfClamp = 4, kLfBaseZero = 8, kLfTileReset = 16 };

  // read_delta_lflevel: each running delta (FRAME_LF_COUNT of them, 2 in a monochrome frame, or the one
  // delta_lf_from_base) plus its coded delta times delta_lf_res, clamped; each has its CDF
  void read_delta_lf() {
    if ((mi_size == (seq.sb128 ? B128X128 : B64X64) && skip) || !read_deltas || !delta_lf_present) return;
    int count = delta_lf_multi ? (planes > 1 ? 4 : 2) : 1;
    for (int i = 0; i < count; ++i) {
      int d = delta_value(delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf);
      if (!d) continue;
      delta_lf_paths |= (delta_lf_multi ? kLfMulti : 0) | (delta_lf_res > 1 ? kLfRes : 0);
      int v = delta_lf[i] + d * delta_lf_res;
      if (v < -63 || v > 63) delta_lf_paths |= kLfClamp;
      delta_lf[i] = std::min(63, std::max(-63, v));
    }
  }

  // 5.11.15-17: TX_MODE_LARGEST takes the largest transform of the block; TX_MODE_SELECT reads up to two splits. The
  // context (libaom's get_tx_size_context) compares the transform coded above and left with the largest, or an
  // intra block copy's block size
  void read_tx_size() {
    if (lossless) { tx_size = TX_4X4; return; }
    tx_size = kMaxTxRect[mi_size];
    if (mi_size == B4X4 || !tx_mode_select) return;
    int max_depth = kMaxTxDepth[mi_size];
    const int64_t a = (int64_t)(mi_row - 1) * mi_cols + mi_col, l = (int64_t)mi_row * mi_cols + mi_col - 1;
    int above = avail_u && (is_inters[a] ? kWide4[mi_sizes[a]] * 4 : above_txfm[mi_col]) >= tx_w(tx_size);
    int left = avail_l && (is_inters[l] ? kHigh4[mi_sizes[l]] * 4 : left_txfm[mi_row]) >= tx_h(tx_size);
    int ctx = above + left;
    int depth;
    if (max_depth == 1) depth = sym.read(cdf.tx8[ctx], 2);
    else depth = sym.read(max_depth == 2 ? cdf.tx16[ctx] : max_depth == 3 ? cdf.tx32[ctx] : cdf.tx64[ctx], 3);
    for (int i = 0; i < depth; ++i) tx_size = kSplitTx[tx_size];
  }

  // set_txfm_ctxs: a block's transform width and height (in pixels) as the split contexts of the blocks below and
  // to its right
  void set_txfm_ctxs(int w, int h) {
    std::fill_n(&above_txfm[mi_col], kWide4[mi_size], (uint8_t)w);
    std::fill_n(&left_txfm[mi_row], kHigh4[mi_size], (uint8_t)h);
  }

  // The transform sizes of an intra block copy (5.11.16-17, libaom's read_tx_size_vartx): under TX_MODE_SELECT a
  // coded block above 4x4 reads a split tree of each largest transform, two levels deep; otherwise every transform is
  // the largest (4x4 when lossless), and a skipped block leaves its own size as the contexts
  void read_block_tx_size() {
    const int bw4 = kWide4[mi_size], bh4 = kHigh4[mi_size];
    if (tx_mode_select && mi_size > B4X4 && !skip && !lossless) {
      const int mtx = kMaxTxRect[mi_size];
      for (int y = 0; y < bh4; y += tx_h(mtx) >> 2)
        for (int x = 0; x < bw4; x += tx_w(mtx) >> 2) read_var_tx_size(mtx, 0, y, x);
      return;
    }
    tx_size = lossless ? TX_4X4 : kMaxTxRect[mi_size];
    for (int y = 0; y < bh4; ++y) std::memset(inter_tx[y], tx_size, bw4);
    if (skip) set_txfm_ctxs(bw4 * 4, bh4 * 4);
    else set_txfm_ctxs(tx_w(tx_size), tx_h(tx_size));
  }

  void read_var_tx_size(int tx, int depth, int y, int x) {
    if (mi_row + y >= mi_rows || mi_col + x >= mi_cols) return;
    int leaf = tx;
    if (depth < 2) {
      // txfm_partition_context: whether the transforms above and left are narrower and shorter, by the category of
      // the transform against the block's largest square one
      const int max_sq = std::min(floor_log2((uint32_t)std::max(kWide4[mi_size], kHigh4[mi_size])), 4);
      const int category = (tx_sqr_up(tx) != max_sq && max_sq > TX_8X8) + (TX_64X64 - max_sq) * 2;
      const int ctx = tx == TX_4X4 ? 0
                                   : category * 3 + (above_txfm[mi_col + x] < tx_w(tx)) +
                                         (left_txfm[mi_row + y] < tx_h(tx));
      if (sym.read(cdf.txfm_split[ctx], 2)) {
        const int sub = kSplitTx[tx];
        intrabc_paths |= depth ? kPathVarTx2 : kPathVarTx1;
        if (sub != TX_4X4) {
          for (int i = 0; i < tx_h(tx) >> 2; i += tx_h(sub) >> 2)
            for (int j = 0; j < tx_w(tx) >> 2; j += tx_w(sub) >> 2) read_var_tx_size(sub, depth + 1, y + i, x + j);
          return;
        }
        leaf = TX_4X4;  // a split into 4x4s goes no further
      }
    }
    // set_inter_tx_size and txfm_partition_update over the coded transform's area
    tx_size = leaf;
    for (int i = 0; i < tx_h(tx) >> 2; ++i) std::memset(&inter_tx[y + i][x], leaf, tx_w(tx) >> 2);
    std::fill_n(&above_txfm[mi_col + x], tx_w(tx) >> 2, (uint8_t)tx_w(leaf));
    std::fill_n(&left_txfm[mi_row + y], tx_h(tx) >> 2, (uint8_t)tx_h(leaf));
  }

  int plane_tx_size(int plane) const {  // get_tx_size
    if (lossless) return TX_4X4;
    if (plane == 0) return tx_size;
    int uv = kMaxTxRect[kSubsampled[mi_size][seq.ssx][seq.ssy]];
    if (tx_w(uv) == 64 || tx_h(uv) == 64) {
      if (tx_w(uv) == 16) return TX_16X32;
      if (tx_h(uv) == 16) return TX_32X16;
      return TX_32X32;
    }
    return uv;
  }

  // ---- residual and reconstruction (5.11.34, 7.11, 7.13) ----
  // Per 64x64 chunk and plane, the transform blocks in raster order; an intra block copy's luma (not lossless)
  // walks each largest transform's split tree (transform_tree) down to the sizes read for it.
  void residual() {
    int wc = std::max(1, kWide4[mi_size] >> 4), hc = std::max(1, kHigh4[mi_size] >> 4);
    for (int cy = 0; cy < hc; ++cy) {
      for (int cx = 0; cx < wc; ++cx) {
        for (int plane = 0; plane < 1 + 2 * has_chroma; ++plane) {
          const bool tree = use_intrabc && !lossless && plane == 0;
          int tx = tree ? kMaxTxRect[mi_size] : plane_tx_size(plane);
          int step_x = tx_w(tx) >> 2, step_y = tx_h(tx) >> 2;
          int psz = kSubsampled[mi_size][ssx(plane)][ssy(plane)];
          int n4w = kWide4[psz], n4h = kHigh4[psz];
          int base_x = (mi_col >> ssx(plane)) * 4, base_y = (mi_row >> ssy(plane)) * 4;
          for (int y = 0; y < std::min(n4h, 16 >> ssy(plane)); y += step_y)
            for (int x = 0; x < std::min(n4w, 16 >> ssx(plane)); x += step_x) {
              const int bx = x + ((cx << 4) >> ssx(plane)), by = y + ((cy << 4) >> ssy(plane));
              if (tree) transform_tree(base_x, base_y, tx, bx, by);
              else transform_block(plane, base_x, base_y, tx, bx, by);
            }
        }
      }
    }
  }

  // the luma transform ``tx`` at 4x4 unit (x, y) of an intra block copy, split until it is the size read there
  void transform_tree(int base_x, int base_y, int tx, int x, int y) {
    if (mi_col + x >= mi_cols || mi_row + y >= mi_rows) return;
    if (inter_tx[y][x] == tx) {
      transform_block(0, base_x, base_y, tx, x, y);
      return;
    }
    const int sub = kSplitTx[tx];
    for (int i = 0; i < tx_h(tx) >> 2; i += tx_h(sub) >> 2)
      for (int j = 0; j < tx_w(tx) >> 2; j += tx_w(sub) >> 2) transform_tree(base_x, base_y, sub, x + j, y + i);
  }

  void transform_block(int plane, int base_x, int base_y, int tx, int x, int y) {
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int sx = ssx(plane), sy = ssy(plane);
    int row = (start_y << sy) >> 2, col = (start_x << sx) >> 2;
    int sb_mask = seq.sb128 ? 31 : 15;
    int sub_row = (row & sb_mask) >> sy, sub_col = (col & sb_mask) >> sx;
    int step_x = tx_w(tx) >> 2, step_y = tx_h(tx) >> 2;
    int max_x = mi_cols * 4 - 1, max_y = mi_rows * 4 - 1;
    if (start_x >= (max_x >> sx) + 1 || start_y >= (max_y >> sy) + 1) return;
    bool is_cfl = plane > 0 && uv_mode == UV_CFL_PRED;
    int mode = plane == 0 ? y_mode : (is_cfl ? DC_PRED : uv_mode);
    if (use_intrabc) {
      // predicted with the whole block (predict_intrabc)
    } else if (palette_size[plane > 0]) {  // 7.11.4: the colours of the map's indices
      const uint16_t* colors = palette_colors[plane];
      const int k = plane > 0, w = tx_w(tx), h = tx_h(tx);
      const uint8_t* m = color_map[k] + (y * 4) * map_w[k] + x * 4;
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) px(plane, start_y + i, start_x + j) = colors[m[i * map_w[k] + j]];
    } else {
      predict_intra(plane, start_x, start_y, (plane == 0 ? avail_l : avail_l_chroma) || x > 0,
                    (plane == 0 ? avail_u : avail_u_chroma) || y > 0,
                    block_decoded(plane, sub_row - 1, sub_col + step_x),
                    block_decoded(plane, sub_row + step_y, sub_col - 1), mode, kTxWLog2[tx], kTxHLog2[tx]);
      if (is_cfl) predict_cfl(plane, start_x, start_y, tx);
    }
    if (plane == 0) {
      max_luma_w = start_x + step_x * 4;
      max_luma_h = start_y + step_y * 4;
    }
    if (!skip) {
      int tx_type;
      int eob = coeffs(plane, start_x, start_y, tx, &tx_type);
      if (eob > 0) reconstruct(plane, start_x, start_y, tx, tx_type);
    }
    for (int i = 0; i < step_y; ++i)
      for (int j = 0; j < step_x; ++j) block_decoded(plane, sub_row + i, sub_col + j) = 1;
  }

  int is_smooth(int r, int c, int plane) const {
    int m = plane == 0 ? y_modes[r * mi_cols + c] : uv_modes[r * mi_cols + c];
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
  }

  int filter_type(int plane) const {  // get_filter_type
    int above = 0, left = 0;
    if (plane == 0 ? avail_u : avail_u_chroma) {
      int r = mi_row - 1, c = mi_col;
      if (plane > 0) {
        if (seq.ssx && !(mi_col & 1)) ++c;
        if (seq.ssy && (mi_row & 1)) --r;
      }
      above = is_smooth(r, c, plane);
    }
    if (plane == 0 ? avail_l : avail_l_chroma) {
      int r = mi_row, c = mi_col - 1;
      if (plane > 0) {
        if (seq.ssx && (mi_col & 1)) --c;
        if (seq.ssy && !(mi_row & 1)) ++r;
      }
      left = is_smooth(r, c, plane);
    }
    return above || left;
  }

  // 7.11.2: the prediction of a (1 << log2w) x (1 << log2h) transform block at (x, y) of ``plane``
  void predict_intra(int plane, int x, int y, int have_left, int have_above, int have_above_rt,
                     int have_below_lft, int mode, int log2w, int log2h) {
    const int w = 1 << log2w, h = 1 << log2h, bd = seq.bit_depth;
    int max_x = ((mi_cols * 4) >> ssx(plane)) - 1, max_y = ((mi_rows * 4) >> ssy(plane)) - 1;
    int above_buf[16 + 2 * 128 + 32], left_buf[16 + 2 * 128 + 32];
    int* above = above_buf + 16;  // index -16 .. : room for the upsampled edge
    int* left = left_buf + 16;
    for (int i = 0; i < w + h; ++i) {
      if (!have_above && have_left) above[i] = px(plane, y, x - 1);
      else if (!have_above) above[i] = (1 << (bd - 1)) - 1;
      else {
        int limit = std::min(max_x, x + (have_above_rt ? 2 * w : w) - 1);
        above[i] = px(plane, y - 1, std::min(limit, x + i));
      }
      if (!have_left && have_above) left[i] = px(plane, y - 1, x);
      else if (!have_left) left[i] = (1 << (bd - 1)) + 1;
      else {
        int limit = std::min(max_y, y + (have_below_lft ? 2 * h : h) - 1);
        left[i] = px(plane, std::min(limit, y + i), x - 1);
      }
    }
    if (have_above && have_left) above[-1] = px(plane, y - 1, x - 1);
    else if (have_above) above[-1] = px(plane, y - 1, x);
    else if (have_left) above[-1] = px(plane, y, x - 1);
    else above[-1] = 1 << (bd - 1);
    left[-1] = above[-1];
    static thread_local int pred[64][64];
    const int maxv = (1 << bd) - 1;
    auto clip = [&](int v) { return v < 0 ? 0 : v > maxv ? maxv : v; };
    if (plane == 0 && use_filter_intra) {
      // 7.11.2.3: recursive intra prediction, 4x2 cells
      for (int i2 = 0; i2 < h / 2; ++i2) {
        for (int j4 = 0; j4 < w / 4; ++j4) {
          int p[7];
          for (int i = 0; i < 7; ++i) {
            if (i < 5) {
              if (i2 == 0) p[i] = above[(j4 << 2) + i - 1];
              else if (j4 == 0 && i == 0) p[i] = left[(i2 << 1) - 1];
              else p[i] = pred[(i2 << 1) - 1][(j4 << 2) + i - 1];
            } else {
              if (j4 == 0) p[i] = left[(i2 << 1) + i - 5];
              else p[i] = pred[(i2 << 1) + i - 5][(j4 << 2) - 1];
            }
          }
          for (int i = 0; i < 8; ++i) {
            int pr = 0;
            for (int j = 0; j < 7; ++j) pr += kFilterIntraTaps[filter_intra_mode][i][j] * p[j];
            int v = pr >= 0 ? (pr + 8) >> 4 : -((-pr + 8) >> 4);
            pred[(i2 << 1) + (i >> 2)][(j4 << 2) + (i & 3)] = clip(v);
          }
        }
      }
    } else if (mode >= V_PRED && mode <= D67_PRED) {
      int angle_delta = plane == 0 ? angle_y : angle_uv;
      int p_angle = kModeToAngle[mode] + angle_delta * 3;
      int up_above = 0, up_left = 0;
      if (seq.edge_filter) {
        if (p_angle != 90 && p_angle != 180) {
          if (p_angle > 90 && p_angle < 180 && w + h >= 24) {  // filter_corner
            int s = left[0] * 5 + above[-1] * 6 + above[0] * 5;
            above[-1] = left[-1] = (s + 8) >> 4;
          }
          int ftype = filter_type(plane);
          if (have_above) {
            int strength = edge_strength(w, h, ftype, p_angle - 90);
            int num = std::min(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
            edge_filter(above, num, strength);
          }
          if (have_left) {
            int strength = edge_strength(w, h, ftype, p_angle - 180);
            int num = std::min(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
            edge_filter(left, num, strength);
          }
          up_above = use_upsample(w, h, ftype, p_angle - 90);
          if (up_above) edge_upsample(above, w + (p_angle < 90 ? h : 0), bd);
          up_left = use_upsample(w, h, ftype, p_angle - 180);
          if (up_left) edge_upsample(left, h + (p_angle > 180 ? w : 0), bd);
        }
      }
      int dx = 0, dy = 0;
      if (p_angle < 90) dx = kDrIntraDerivative[p_angle];
      else if (p_angle > 90 && p_angle < 180) dx = kDrIntraDerivative[180 - p_angle];
      if (p_angle > 90 && p_angle < 180) dy = kDrIntraDerivative[p_angle - 90];
      else if (p_angle > 180) dy = kDrIntraDerivative[270 - p_angle];
      for (int i = 0; i < h; ++i) {
        for (int j = 0; j < w; ++j) {
          int v;
          if (p_angle < 90) {
            int idx = (i + 1) * dx;
            int base = (idx >> (6 - up_above)) + (j << up_above);
            int shift = ((idx << up_above) >> 1) & 0x1F;
            int max_base = (w + h - 1) << up_above;
            if (base < max_base) v = (above[base] * (32 - shift) + above[base + 1] * shift + 16) >> 5;
            else v = above[max_base];
          } else if (p_angle > 90 && p_angle < 180) {
            int idx = (j << 6) - (i + 1) * dx;
            int base = idx >> (6 - up_above);
            if (base >= -(1 << up_above)) {
              int shift = ((idx * (1 << up_above)) >> 1) & 0x1F;
              v = (above[base] * (32 - shift) + above[base + 1] * shift + 16) >> 5;
            } else {
              idx = (i << 6) - (j + 1) * dy;
              base = idx >> (6 - up_left);
              int shift = ((idx * (1 << up_left)) >> 1) & 0x1F;
              v = (left[base] * (32 - shift) + left[base + 1] * shift + 16) >> 5;
            }
          } else if (p_angle > 180) {
            int idx = (j + 1) * dy;
            int base = (idx >> (6 - up_left)) + (i << up_left);
            int shift = ((idx << up_left) >> 1) & 0x1F;
            v = (left[base] * (32 - shift) + left[base + 1] * shift + 16) >> 5;
          } else if (p_angle == 90) {
            v = above[j];
          } else {
            v = left[i];
          }
          pred[i][j] = v;
        }
      }
    } else if (mode == SMOOTH_PRED) {
      const uint8_t *wy = sm_weights(log2h), *wx = sm_weights(log2w);
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          int s = wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + wx[j] * left[i] + (256 - wx[j]) * above[w - 1];
          pred[i][j] = (s + 256) >> 9;
        }
    } else if (mode == SMOOTH_V_PRED) {
      const uint8_t* wy = sm_weights(log2h);
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) pred[i][j] = (wy[i] * above[j] + (256 - wy[i]) * left[h - 1] + 128) >> 8;
    } else if (mode == SMOOTH_H_PRED) {
      const uint8_t* wx = sm_weights(log2w);
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) pred[i][j] = (wx[j] * left[i] + (256 - wx[j]) * above[w - 1] + 128) >> 8;
    } else if (mode == DC_PRED) {
      int avg;
      if (have_left && have_above) {
        int sum = 0;
        for (int k = 0; k < h; ++k) sum += left[k];
        for (int k = 0; k < w; ++k) sum += above[k];
        avg = (sum + ((w + h) >> 1)) / (w + h);
      } else if (have_left) {
        int sum = 0;
        for (int k = 0; k < h; ++k) sum += left[k];
        avg = clip((sum + (h >> 1)) >> log2h);
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; ++k) sum += above[k];
        avg = clip((sum + (w >> 1)) >> log2w);
      } else {
        avg = 1 << (bd - 1);
      }
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) pred[i][j] = avg;
    } else {  // PAETH_PRED
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          int base = above[j] + left[i] - above[-1];
          int p_left = std::abs(base - left[i]), p_top = std::abs(base - above[j]),
              p_top_left = std::abs(base - above[-1]);
          pred[i][j] = (p_left <= p_top && p_left <= p_top_left) ? left[i] : p_top <= p_top_left ? above[j] : above[-1];
        }
    }
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) px(plane, y + i, x + j) = (uint16_t)pred[i][j];
  }

  // 7.11.2.9
  static int edge_strength(int w, int h, int filter_type, int delta) {
    int d = std::abs(delta), wh = w + h, s = 0;
    if (filter_type == 0) {
      if (wh <= 8) { if (d >= 56) s = 1; }
      else if (wh <= 16) { if (d >= 40) s = 1; }
      else if (wh <= 24) { if (d >= 8) s = 1; if (d >= 16) s = 2; if (d >= 32) s = 3; }
      else if (wh <= 32) { if (d >= 1) s = 1; if (d >= 4) s = 2; if (d >= 32) s = 3; }
      else { if (d >= 1) s = 3; }
    } else {
      if (wh <= 8) { if (d >= 40) s = 1; if (d >= 64) s = 2; }
      else if (wh <= 16) { if (d >= 20) s = 1; if (d >= 48) s = 2; }
      else if (wh <= 24) { if (d >= 4) s = 3; }
      else { if (d >= 1) s = 3; }
    }
    return s;
  }

  // 7.11.2.10
  static int use_upsample(int w, int h, int filter_type, int delta) {
    int d = std::abs(delta);
    if (d <= 0 || d >= 40) return 0;
    return filter_type ? (w + h <= 8) : (w + h <= 16);
  }

  // 7.11.2.12: the edge filter over edge[-1 .. sz - 2]
  static void edge_filter(int* edge, int sz, int strength) {
    if (!strength) return;
    int e[160];
    for (int i = 0; i < sz; ++i) e[i] = edge[i - 1];
    for (int i = 1; i < sz; ++i) {
      int s = 0;
      for (int j = 0; j < 5; ++j) {
        int k = std::min(std::max(i - 2 + j, 0), sz - 1);
        s += kEdgeKernel[strength - 1][j] * e[k];
      }
      edge[i - 1] = (s + 8) >> 4;
    }
  }

  // 7.11.2.11
  static void edge_upsample(int* buf, int num, int bd) {
    int dup[40];
    dup[0] = buf[-1];
    for (int i = -1; i < num; ++i) dup[i + 2] = buf[i];
    dup[num + 2] = buf[num - 1];
    buf[-2] = dup[0];
    const int maxv = (1 << bd) - 1;
    for (int i = 0; i < num; ++i) {
      int s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3];
      s = (s + 8) >> 4;
      buf[2 * i - 1] = s < 0 ? 0 : s > maxv ? maxv : s;
      buf[2 * i] = dup[i + 2];
    }
  }

  // 7.11.5: chroma from luma, the luma averaged over each chroma sample's area and padded past what is decoded
  void predict_cfl(int plane, int x, int y, int tx) {
    const int w = tx_w(tx), h = tx_h(tx), sx = seq.ssx, sy = seq.ssy;
    int alpha = plane == 1 ? cfl_alpha_u : cfl_alpha_v;
    static thread_local int l[32][32];
    int64_t sum = 0;
    for (int i = 0; i < h; ++i) {
      int ly = std::min((y + i) << sy, max_luma_h - (1 << sy));
      for (int j = 0; j < w; ++j) {
        int lx = std::min((x + j) << sx, max_luma_w - (1 << sx));
        int t = 0;
        for (int dy = 0; dy <= sy; ++dy)
          for (int dx = 0; dx <= sx; ++dx) t += px(0, ly + dy, lx + dx);
        l[i][j] = t << (3 - sx - sy);
        sum += l[i][j];
      }
    }
    int shift = kTxWLog2[tx] + kTxHLog2[tx];
    int avg = (int)((sum + (1ll << (shift - 1))) >> shift);
    const int maxv = (1 << seq.bit_depth) - 1;
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        int scaled = alpha * (l[i][j] - avg);
        scaled = scaled >= 0 ? (scaled + 32) >> 6 : -((-scaled + 32) >> 6);
        int v = px(plane, y + i, x + j) + scaled;
        px(plane, y + i, x + j) = (uint16_t)(v < 0 ? 0 : v > maxv ? maxv : v);
      }
  }

  int tx_set(int tx) const {  // get_tx_set of the block (an intra block copy is an inter block)
    if (tx_sqr_up(tx) > TX_32X32) return TX_SET_DCTONLY;
    if (use_intrabc) {
      if (reduced_tx_set || tx_sqr_up(tx) == TX_32X32) return TX_SET_INTER_3;
      return tx_sqr(tx) == TX_16X16 ? TX_SET_INTER_2 : TX_SET_INTER_1;
    }
    if (tx_sqr_up(tx) == TX_32X32) return TX_SET_DCTONLY;
    if (reduced_tx_set || tx_sqr(tx) == TX_16X16) return TX_SET_INTRA_2;
    return TX_SET_INTRA_1;
  }

  static bool in_set(int set, int tx_type) {  // av1_ext_tx_used
    switch (set) {
      case TX_SET_DCTONLY: return tx_type == DCT_DCT;
      case TX_SET_INTER_3: return tx_type == DCT_DCT || tx_type == IDTX;
      case TX_SET_INTRA_2: return tx_type <= ADST_ADST || tx_type == IDTX;
      case TX_SET_INTRA_1: return tx_type <= ADST_ADST || (tx_type >= IDTX && tx_type <= H_DCT);
      case TX_SET_INTER_2: return tx_type <= H_DCT;
    }
    return true;  // TX_SET_INTER_1: all 16
  }

  static int tx_class(int tx_type) {
    if (tx_type == V_DCT || tx_type == V_ADST || tx_type == V_FLIPADST) return TX_CLASS_VERT;
    if (tx_type == H_DCT || tx_type == H_ADST || tx_type == H_FLIPADST) return TX_CLASS_HORIZ;
    return TX_CLASS_2D;
  }

  // 5.11.47: the luma transform type, read or DCT_DCT, stored for the block's 4x4 units
  int read_tx_type(int x4, int y4, int tx) {
    int set = tx_set(tx), type = DCT_DCT;
    // libaom reads a type where the segment's quantizer without delta q (xd->qindex) is above 0; an intra block
    // copy's from the inter CDFs by square size, without an intra direction
    if (set >= TX_SET_INTER_1 && seg_qindex[segment_id] > 0) {
      intrabc_paths |= kPathSet1 << (set - TX_SET_INTER_1);
      if (set == TX_SET_INTER_1) type = kTxTypeInterInvSet1[sym.read(cdf.inter_tx1[tx_sqr(tx)], 16)];
      else if (set == TX_SET_INTER_2) type = kTxTypeInterInvSet2[sym.read(cdf.inter_tx2[tx_sqr(tx)], 12)];
      else type = sym.read(cdf.inter_tx3[tx_sqr(tx)], 2) ? DCT_DCT : IDTX;
    } else if (set != TX_SET_DCTONLY && seg_qindex[segment_id] > 0) {
      int dir = use_filter_intra ? kFilterIntraModeToIntraDir[filter_intra_mode] : y_mode;
      if (set == TX_SET_INTRA_1) type = kTxTypeIntraInvSet1[sym.read(cdf.intra_tx1[tx_sqr(tx)][dir], 7)];
      else type = kTxTypeIntraInvSet2[sym.read(cdf.intra_tx2[tx_sqr(tx)][dir], 5)];
    }
    for (int i = 0; i < (tx_h(tx) >> 2) && y4 + i < mi_rows; ++i)
      for (int j = 0; j < (tx_w(tx) >> 2) && x4 + j < mi_cols; ++j) tx_types[(y4 + i) * mi_cols + x4 + j] = (uint8_t)type;
    return type;
  }

  int plane_tx_type(int plane, int tx, int x4, int y4) const {  // compute_tx_type
    if (lossless || tx_sqr_up(tx) > TX_32X32) return DCT_DCT;
    if (plane == 0) return tx_types[y4 * mi_cols + x4];
    if (use_intrabc) {  // the luma type at the block's co-located 4x4 unit, where the chroma size's set has it
      const int r = mi_row + ((y4 - (mi_row >> ssy(plane))) << ssy(plane));
      const int c = mi_col + ((x4 - (mi_col >> ssx(plane))) << ssx(plane));
      const int type = tx_types[(int64_t)r * mi_cols + c];
      return in_set(tx_set(tx), type) ? type : DCT_DCT;
    }
    // the UV mode's type (a DCT or ADST pair, in both intra sets), where the size has a set
    return tx_set(tx) == TX_SET_DCTONLY ? DCT_DCT : kModeToTxfm[uv_mode];
  }

  // 5.11.39: a transform block's coefficients, dequantized into ``dequant`` -> the end of block
  int coeffs(int plane, int start_x, int start_y, int tx, int* tx_type_out) {
    const int ptype = plane > 0;
    const int x4 = start_x >> 2, y4 = start_y >> 2, w4 = tx_w(tx) >> 2, h4 = tx_h(tx) >> 2;
    const int max_x4 = mi_cols >> ssx(plane), max_y4 = mi_rows >> ssy(plane);
    const int tx_ctx = (tx_sqr(tx) + tx_sqr_up(tx) + 1) >> 1;
    const int w = tx_w(tx), h = tx_h(tx);
    int ctx;
    int psz = kSubsampled[mi_size][ssx(plane)][ssy(plane)];
    int bw = kWide4[psz] * 4, bh = kHigh4[psz] * 4;
    if (plane == 0) {
      int top = 0, left = 0;
      for (int k = 0; k < w4; ++k)
        if (x4 + k < max_x4) top = std::max<int>(top, above_level[0][x4 + k]);
      for (int k = 0; k < h4; ++k)
        if (y4 + k < max_y4) left = std::max<int>(left, left_level[0][y4 + k]);
      top = std::min(top, 255);
      left = std::min(left, 255);
      if (bw == w && bh == h) ctx = 0;
      else if (!top && !left) ctx = 1;
      else if (!top || !left) ctx = 2 + (std::max(top, left) > 3);
      else if (std::max(top, left) <= 3) ctx = 4;
      else if (std::min(top, left) <= 3) ctx = 5;
      else ctx = 6;
    } else {
      int above = 0, left = 0;
      for (int k = 0; k < w4; ++k)
        if (x4 + k < max_x4) above |= above_level[plane][x4 + k] | above_dc[plane][x4 + k];
      for (int k = 0; k < h4; ++k)
        if (y4 + k < max_y4) left |= left_level[plane][y4 + k] | left_dc[plane][y4 + k];
      ctx = 7 + (above != 0) + (left != 0) + (bw * bh > w * h ? 3 : 0);
    }
    int all_zero = sym.read(cdf.txb_skip[tx_ctx][ctx], 2);
    int cul_level = 0, dc_category = 0, eob = 0;
    if (all_zero) {
      if (plane == 0)
        for (int i = 0; i < h4 && (start_y >> 2) + i < mi_rows; ++i)
          for (int j = 0; j < w4 && x4 + j < mi_cols; ++j) tx_types[(y4 + i) * mi_cols + x4 + j] = DCT_DCT;
    } else {
      if (plane == 0) read_tx_type(x4, y4, tx);
      const int tx_type = plane_tx_type(plane, tx, x4, y4);
      *tx_type_out = tx_type;
      // the coded part: at most 32x32
      const int aw = std::min(w, 32), ah = std::min(h, 32), bwl = floor_log2((uint32_t)aw);
      const int cls = tx_class(tx_type);
      const int16_t* scan;
      if (tx_sqr_up(tx) == TX_64X64) scan = default_scan(aw, ah);
      else if (cls == TX_CLASS_VERT) scan = mrow_scan(w, h);
      else if (cls == TX_CLASS_HORIZ) scan = mcol_scan(w, h);
      else scan = default_scan(w, h);
      const int area = aw * ah;
      std::memset(quant, 0, sizeof(int32_t) * area);
      int multi = std::min(kTxWLog2[tx], 5) + std::min(kTxHLog2[tx], 5) - 4;
      int ectx = cls == TX_CLASS_2D ? 0 : 1, eob_pt;
      switch (multi) {
        case 0: eob_pt = sym.read(cdf.eob16[ptype][ectx], 5) + 1; break;
        case 1: eob_pt = sym.read(cdf.eob32[ptype][ectx], 6) + 1; break;
        case 2: eob_pt = sym.read(cdf.eob64[ptype][ectx], 7) + 1; break;
        case 3: eob_pt = sym.read(cdf.eob128[ptype][ectx], 8) + 1; break;
        case 4: eob_pt = sym.read(cdf.eob256[ptype][ectx], 9) + 1; break;
        case 5: eob_pt = sym.read(cdf.eob512[ptype], 10) + 1; break;
        default: eob_pt = sym.read(cdf.eob1024[ptype], 11) + 1; break;
      }
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int shift = eob_pt - 3;
      if (shift >= 0) {
        if (sym.read(cdf.eob_extra[tx_ctx][ptype][eob_pt - 3], 2)) eob += 1 << shift;
        for (int i = 1; i < std::max(0, eob_pt - 2); ++i)
          if (sym.boolean()) eob += 1 << (eob_pt - 3 - i);
      }
      for (int c = eob - 1; c >= 0; --c) {
        int pos = scan[c];
        int level;
        if (c == eob - 1) {
          int bctx = c == 0 ? 0 : c <= area / 8 ? 1 : c <= area / 4 ? 2 : 3;
          level = sym.read(cdf.base_eob[tx_ctx][ptype][bctx], 3) + 1;
        } else {
          level = sym.read(cdf.base[tx_ctx][ptype][base_ctx(tx, cls, pos, aw, ah, bwl)], 4);
        }
        if (level > 2) {
          int bctx = br_ctx(cls, pos, aw, ah, bwl);
          for (int k = 0; k < 4; ++k) {
            int br = sym.read(cdf.br[std::min(tx_ctx, 3)][ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      // dequantization (7.12.3): the quantizer, weighted by the quantizer matrix of a 2D transform
      const int bdi = (seq.bit_depth - 8) >> 1;
      const int q = qindex(0, segment_id);
      if (q != seg_qindex[segment_id] && seg_feature(segment_id, kSegLvlAltQ)) seg_paths |= kSegDeltaQ;
      const int dcq = av1t::kDcQLookup[bdi][std::min(255, std::max(0, q + delta_q_dc[plane]))];
      const int acq = av1t::kAcQLookup[bdi][std::min(255, std::max(0, q + (plane ? delta_q_ac[plane] : 0)))];
      const int qml = seg_qm_level[segment_id][plane];
      const uint8_t* qm = nullptr;
      if (qml < 15 && tx_type < IDTX) qm = av1t::kQuantizerMatrix[qml][ptype] + qm_offset(aw, ah);
      const int dq_shift = (w * h > 256) + (w * h > 1024);
      const int64_t lim = 1ll << (7 + seq.bit_depth);
      std::memset(dequant, 0, sizeof(int32_t) * area);
      for (int c = 0; c < eob; ++c) {
        int pos = scan[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int s = 0;
            for (int k = 0; k < w4; ++k)
              if (x4 + k < max_x4) { int d = above_dc[plane][x4 + k]; s += d == 1 ? -1 : d == 2 ? 1 : 0; }
            for (int k = 0; k < h4; ++k)
              if (y4 + k < max_y4) { int d = left_dc[plane][y4 + k]; s += d == 1 ? -1 : d == 2 ? 1 : 0; }
            sign = sym.read(cdf.dc_sign[ptype][s < 0 ? 1 : s > 0 ? 2 : 0], 2);
          } else {
            sign = sym.boolean();
          }
        }
        int64_t level = quant[pos];
        if (level > 14) {  // read_golomb, as libaom reads it: at most 20 length bits
          int length = 0, bit = 0;
          while (!bit) {
            bit = sym.boolean();
            if (++length > 20) throw Corrupt{__LINE__};
          }
          int64_t x = 1;
          for (int i = length - 2; i >= 0; --i) x = (x << 1) | sym.boolean();
          level = x + 14;
        }
        if (pos == 0 && level > 0) dc_category = sign ? 1 : 2;
        level &= 0xFFFFF;
        cul_level += (int)level;
        if (level) {
          int64_t dqv = pos == 0 ? dcq : acq;
          if (qm) dqv = (qm[pos] * dqv + 16) >> 5;
          int64_t dq = (level * dqv) & 0xFFFFFF;
          dq >>= dq_shift;
          if (sign) dq = -dq;
          dequant[pos] = (int32_t)std::min(std::max(dq, -lim), lim - 1);
        }
      }
      cul_level = std::min(63, cul_level);
    }
    for (int k = 0; k < w4; ++k) {
      above_level[plane][x4 + k] = (uint8_t)cul_level;
      above_dc[plane][x4 + k] = (uint8_t)dc_category;
    }
    for (int k = 0; k < h4; ++k) {
      left_level[plane][y4 + k] = (uint8_t)cul_level;
      left_dc[plane][y4 + k] = (uint8_t)dc_category;
    }
    return eob;
  }

  static int qm_offset(int w, int h) {  // Qm_Offset: the matrices in the order of the coded sizes
    static const int sizes[14][2] = {{4, 4}, {8, 8}, {16, 16}, {32, 32}, {4, 8}, {8, 4}, {8, 16}, {16, 8},
                                     {16, 32}, {32, 16}, {4, 16}, {16, 4}, {8, 32}, {32, 8}};
    int off = 0;
    for (auto& s : sizes) {
      if (s[0] == w && s[1] == h) return off;
      off += s[0] * s[1];
    }
    return 0;
  }

  int base_ctx(int tx, int cls, int pos, int aw, int ah, int bwl) const {
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int k = 0; k < 5; ++k) {
      int r = row + kSigRefDiffOffset[cls][k][0], c = col + kSigRefDiffOffset[cls][k][1];
      if (r < ah && c < aw) mag += std::min(std::abs(quant[(r << bwl) + c]), 3);
    }
    int ctx = std::min((mag + 1) >> 1, 4);
    if (cls == TX_CLASS_2D) {
      if (row == 0 && col == 0) return 0;
      int shape = tx_w(tx) == tx_h(tx) ? 0 : tx_w(tx) > tx_h(tx) ? 1 : 2;
      return ctx + kCoeffBaseCtxOffset[shape][std::min(row, 4)][std::min(col, 4)];
    }
    int idx = cls == TX_CLASS_VERT ? row : col;
    return ctx + 26 + 5 * std::min(idx, 2);
  }

  int br_ctx(int cls, int pos, int aw, int ah, int bwl) const {
    int row = pos >> bwl, col = pos - (row << bwl);
    int mag = 0;
    for (int k = 0; k < 3; ++k) {
      int r = row + kMagRefOffset[cls][k][0], c = col + kMagRefOffset[cls][k][1];
      if (r < ah && c < aw) mag += std::min(quant[r * aw + c], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (cls == TX_CLASS_2D) {
      if (row < 2 && col < 2) return mag + 7;
    } else if (cls == TX_CLASS_HORIZ) {
      if (col == 0) return mag + 7;
    } else {
      if (row == 0) return mag + 7;
    }
    return mag + 14;
  }

  // 7.13.3: the inverse transform of ``dequant``, added to the prediction
  void reconstruct(int plane, int x, int y, int tx, int tx_type) {
    const int w = tx_w(tx), h = tx_h(tx);
    if (lossless) {
      inverse_wht(dequant, resid);
    } else {
      inverse_transform_2d(dequant, tx, tx_type, seq.bit_depth, resid);
    }
    const int maxv = (1 << seq.bit_depth) - 1;
    for (int i = 0; i < h; ++i)
      for (int j = 0; j < w; ++j) {
        int64_t v = px(plane, y + i, x + j) + (int64_t)resid[i * w + j];
        px(plane, y + i, x + j) = (uint16_t)(v < 0 ? 0 : v > maxv ? maxv : v);
      }
  }

  // 7.13.2.10: the inverse Walsh-Hadamard transform of a lossless 4x4 block (rows with shift 2, then columns)
  static void inverse_wht(const int32_t* coef, int32_t* out) {
    int64_t t[4][4];
    for (int i = 0; i < 4; ++i) {
      int64_t a = coef[i * 4 + 0] >> 2, c = coef[i * 4 + 1] >> 2, d = coef[i * 4 + 2] >> 2, b = coef[i * 4 + 3] >> 2;
      a += c; d -= b;
      int64_t e = (a - d) >> 1;
      b = e - b; c = e - c;
      a -= b; d += c;
      t[i][0] = a; t[i][1] = b; t[i][2] = c; t[i][3] = d;
    }
    for (int j = 0; j < 4; ++j) {
      int64_t a = t[0][j], c = t[1][j], d = t[2][j], b = t[3][j];
      a += c; d -= b;
      int64_t e = (a - d) >> 1;
      b = e - b; c = e - c;
      a -= b; d += c;
      out[0 * 4 + j] = (int32_t)a; out[1 * 4 + j] = (int32_t)b; out[2 * 4 + j] = (int32_t)c; out[3 * 4 + j] = (int32_t)d;
    }
  }

  // ---- the OBU layer (5.3) ----
  void decode(const uint8_t* p, int64_t n) {
    int64_t at = 0;
    while (at < n) {
      if (decoded && p[at] == 0) {  // libaom skips zero bytes after a frame
        ++at;
        continue;
      }
      uint8_t h = p[at++];
      int type = (h >> 3) & 15, ext = (h >> 2) & 1;
      // libaom's read_obu_header: the forbidden and reserved bits 0, a size field, a type it knows
      if ((h & 0x80) || !(h & 2) || (h & 1) || type == 0 || (type > 8 && type != 15)) throw Corrupt{__LINE__};
      if (ext) {
        if (at >= n || (p[at] & 7)) throw Corrupt{__LINE__};  // extension_header_reserved_3bits
        ++at;
      }
      int64_t size = (int64_t)leb128(p, n, &at);
      if (size < 0 || size > n - at) throw Corrupt{__LINE__};
      const uint8_t* body = p + at;
      if (type == 1) {  // sequence header
        Bits b{body, size, 0};
        sequence_header(b);
        b.trailing(size * 8);
      } else if (type == 2) {  // temporal delimiter
        seen_frame_header = false;
      } else if (decoded && (type == 3 || type == 4 || type == 6)) {
        throw Corrupt{__LINE__};  // a second frame in the payload, which libavif does not take
      } else if (type == 3 || type == 6 || type == 7) {  // frame header, frame, redundant frame header
        if (!seen_frame_header) {
          if (type == 7) throw Corrupt{__LINE__};
          Bits b{body, size, 0};
          frame_header(b);
          seen_frame_header = true;
          start_frame();
          if (type == 3) {
            b.trailing(size * 8);
          } else {
            b.byte_alignment();
            tile_group(body + b.pos / 8, size - b.pos / 8);
          }
        } else if (type == 6) {
          throw Corrupt{__LINE__};
        }
      } else if (type == 4) {  // tile group
        if (!seen_frame_header) throw Corrupt{__LINE__};
        tile_group(body, size);
      } else if (type == 8) {
        throw Corrupt{__LINE__};  // a tile list OBU: libaom decodes none outside large-scale tile mode
      } else if (type == 15 && size > 0) {  // padding: libaom wants its last non-zero byte 0x80
        int64_t k = size - 1;
        while (k > 0 && body[k] == 0) --k;
        if (body[k] != 0x80) throw Corrupt{__LINE__};
      }
      at += size;
    }
    if (!decoded) throw Corrupt{__LINE__};  // no whole frame: libaom outputs none
    loop_filter();
    cdef();
    for (int p = 0; p < planes; ++p)
      if (lr_type[p]) lr_plane(p);
    for (int p = 0; p < 3; ++p) std::vector<uint16_t>().swap(pre_cdef[p]);
  }

  // ---- the loop filter (7.14), as libaom applies it to a key frame ----
  // Every block is intra, so the level of an edge in a plane and direction
  // is the frame's, moved by the delta LF and the segment's feature of the
  // block on its q side (of the p side where that gives 0), and every
  // transform edge inside the frame is filtered, with the taps the smaller
  // transform across it allows.

  int seg_of(int64_t k) const { return seg_enabled ? segment_ids[k] : 0; }

  // the transform width (pass 0) or height (pass 1) of the 4x4 unit at mode info (r, c) in ``plane`` (libaom's
  // get_transform_size: 4x4 in every plane of a lossless block)
  int lf_tx_side(int plane, int r, int c, int pass) const {
    int64_t k = (int64_t)r * mi_cols + c;
    int tx = tx_sizes[k];
    if (plane > 0 && !seg_lossless[seg_of(k)]) {  // av1_get_max_uv_txsize
      tx = kMaxTxRect[kSubsampled[mi_sizes[k]][seq.ssx][seq.ssy]];
      if (tx_w(tx) == 64 || tx_h(tx) == 64) tx = tx_w(tx) == 16 ? TX_16X32 : tx_h(tx) == 16 ? TX_32X16 : TX_32X32;
    }
    return pass == 0 ? tx_w(tx) : tx_h(tx);
  }

  // av1_get_filter_level: the level of an intra block's edges in ``plane`` and ``pass``, its delta LF ``delta`` and
  // its segment ``seg`` (whose SEG_LVL_ALT_LF_Y_V, _Y_H, _U or _V adds, clamped)
  int lf_block_level(int plane, int pass, int delta, int seg) const {
    int lvl = plane == 0 ? lf_level[pass] : lf_level[plane + 1];
    if (delta_lf_present) lvl = std::min(63, std::max(0, lvl + delta));
    const int feature = kSegLvlAltLfYV + (plane == 0 ? pass : plane + 1);
    if (seg_enabled && seg_feature(seg, feature)) lvl = std::min(63, std::max(0, lvl + seg_data[seg][feature]));
    if (lf_delta_enabled) lvl = std::min(63, std::max(0, lvl + lf_ref_deltas[0] * (1 << (lvl >> 5))));
    return lvl;
  }

  // av1_loop_filter_frame and its set_planes_to_loop_filter: nothing when both luma levels are 0, a chroma plane
  // whose level is 0 skipped whatever its deltas and segments; a pass filters where some block's level may be above 0
  void loop_filter() {
    if (!lf_level[0] && !lf_level[1]) return;
    for (int p = 0; p < planes; ++p) {
      if (p > 0 && !lf_level[p + 1]) continue;
      for (int pass = 0; pass < 2; ++pass) {
        bool any = delta_lf_present;
        for (int s = 0; s < 8 && !any; ++s) any = lf_block_level(p, pass, 0, s) > 0;
        if (any) filter_plane(p, pass);
      }
    }
  }

  // every vertical (pass 0) or horizontal (pass 1) edge of a plane, left to right and top to bottom
  void filter_plane(int plane, int pass) {
    const int sx = ssx(plane), sy = ssy(plane);
    const int w = (width + sx) >> sx, h = (height + sy) >> sy;  // the plane's samples in the frame
    const int shift = seq.bit_depth - 8;
    // update_sharpness: the limits of each level
    int limit[64], blimit[64], thresh[64];
    for (int lvl = 0; lvl < 64; ++lvl) {
      int lim = lvl >> ((lf_sharpness > 0) + (lf_sharpness > 4));
      if (lf_sharpness > 0) lim = std::min(lim, 9 - lf_sharpness);
      lim = std::max(lim, 1);
      limit[lvl] = lim << shift;
      blimit[lvl] = (2 * (lvl + 2) + lim) << shift;
      thresh[lvl] = (lvl >> 4) << shift;
    }
    // delta_lf_id_lut: the running delta of the plane and direction
    static const int kDeltaLfId[3][2] = {{0, 1}, {2, 2}, {3, 3}};
    const int id = delta_lf_multi ? kDeltaLfId[plane][pass] : 0;
    const bool base_zero = (plane == 0 ? lf_level[pass] : lf_level[plane + 1]) == 0;
    // each segment's level without delta LF, and whether its feature raises the pass from a frame level of 0
    const int feature = kSegLvlAltLfYV + (plane == 0 ? pass : plane + 1);
    int seg_lvl[8];
    bool raised[8];
    for (int s = 0; s < 8; ++s) {
      seg_lvl[s] = lf_block_level(plane, pass, 0, s);
      raised[s] = base_zero && seg_enabled && seg_feature(s, feature) && seg_data[s][feature] > 0;
    }
    auto level = [&](int r, int c) {
      const int64_t k = (int64_t)r * mi_cols + c;
      return delta_lf_present ? lf_block_level(plane, pass, delta_lfs[k * 4 + id], seg_of(k)) : seg_lvl[seg_of(k)];
    };
    const ptrdiff_t step = pass == 0 ? 1 : stride[plane], along = pass == 0 ? stride[plane] : 1;
    for (int y4 = 0; 4 * y4 < h; ++y4) {
      for (int x4 = 0; 4 * x4 < w; ++x4) {
        int coord = 4 * (pass == 0 ? x4 : y4);
        if (coord == 0) continue;
        int r = (y4 << sy) | sy, c = (x4 << sx) | sx;
        int side = lf_tx_side(plane, r, c, pass);
        if (coord % side) continue;
        int pr = pass == 0 ? r : r - (1 << sy), pc = pass == 0 ? c - (1 << sx) : c;
        int lvl = level(r, c);
        if (!lvl) lvl = level(pr, pc);  // set_lpf_parameters: the q side's level, else the p side's
        if (!lvl) continue;
        if (base_zero && delta_lf_present) delta_lf_paths |= kLfBaseZero;
        if (raised[seg_of((int64_t)r * mi_cols + c)] || raised[seg_of((int64_t)pr * mi_cols + pc)])
          seg_paths |= kSegLfRaised;
        int m = std::min(side, lf_tx_side(plane, pr, pc, pass));
        int len = m == 4 ? 4 : plane > 0 ? 6 : m == 8 ? 8 : 14;
        uint16_t* s = &px(plane, 4 * y4, 4 * x4);
        for (int i = 0; i < 4; ++i, s += along)
          filter_sample(s, step, len, limit[lvl], blimit[lvl], thresh[lvl], shift);
      }
    }
  }

  // the filter of ``len`` taps across the edge before s[0] (q0; p0 is s[-step]), at one position along it
  static void filter_sample(uint16_t* s, ptrdiff_t step, int len, int limit, int blimit, int thresh, int shift) {
    auto p = [&](int k) -> int { return s[-(k + 1) * step]; };
    auto q = [&](int k) -> int { return s[k * step]; };
    auto ad = [](int a, int b) { return std::abs(a - b); };
    // filter_mask, flat_mask, hev_mask
    bool mask = ad(p(1), p(0)) <= limit && ad(q(1), q(0)) <= limit &&
                ad(p(0), q(0)) * 2 + ad(p(1), q(1)) / 2 <= blimit;
    if (len >= 6) mask = mask && ad(p(2), p(1)) <= limit && ad(q(2), q(1)) <= limit;
    if (len >= 8) mask = mask && ad(p(3), p(2)) <= limit && ad(q(3), q(2)) <= limit;
    if (!mask) return;
    const int one = 1 << shift;
    bool flat = false, flat2 = false;
    if (len >= 6) {
      flat = ad(p(1), p(0)) <= one && ad(q(1), q(0)) <= one && ad(p(2), p(0)) <= one && ad(q(2), q(0)) <= one;
      if (len >= 8) flat = flat && ad(p(3), p(0)) <= one && ad(q(3), q(0)) <= one;
    }
    if (len == 14 && flat) {
      flat2 = true;
      for (int k = 4; k <= 6; ++k) flat2 = flat2 && ad(p(k), p(0)) <= one && ad(q(k), q(0)) <= one;
    }
    if (!flat) {  // filter4
      const int lo = -(128 << shift), hi = (128 << shift) - 1, off = 128 << shift;
      auto c = [&](int v) { return v < lo ? lo : v > hi ? hi : v; };
      const int ps1 = p(1) - off, ps0 = p(0) - off, qs0 = q(0) - off, qs1 = q(1) - off;
      const bool hev = ad(p(1), p(0)) > thresh || ad(q(1), q(0)) > thresh;
      int f = hev ? c(ps1 - qs1) : 0;
      f = c(f + 3 * (qs0 - ps0));
      const int f1 = c(f + 4) >> 3, f2 = c(f + 3) >> 3;
      s[0] = (uint16_t)(c(qs0 - f1) + off);
      s[-step] = (uint16_t)(c(ps0 + f2) + off);
      if (!hev) {
        f = (f1 + 1) >> 1;
        s[step] = (uint16_t)(c(qs1 - f) + off);
        s[-2 * step] = (uint16_t)(c(ps1 + f) + off);
      }
      return;
    }
    // the wide filter (7.14.6.4): 2n taps each side of weight 1, the middle ones 2, rounded by 2^log2
    const int log2 = flat2 ? 4 : 3, n = flat2 ? 6 : len == 6 ? 2 : 3, n2 = (log2 == 3 && len != 6) ? 0 : 1;
    int v[14], out[12];
    for (int k = -(n + 1); k <= n; ++k) v[k + n + 1] = k < 0 ? p(-k - 1) : q(k);
    for (int i = -n; i < n; ++i) {
      int t = 0;
      for (int j = -n; j <= n; ++j) {
        int at = std::min(n, std::max(-(n + 1), i + j));
        t += (std::abs(j) <= n2 ? 2 : 1) * v[at + n + 1];
      }
      out[i + n] = (t + (1 << (log2 - 1))) >> log2;
    }
    for (int i = -n; i < n; ++i) s[i * step] = (uint16_t)out[i + n];
  }

  // ---- CDEF (7.15), as libaom's av1_cdef_frame applies it ----
  // Every 8x8 of a 64x64 whose index is not -1 and whose four 4x4 units do
  // not all skip is filtered: luma along the direction found on its own
  // samples, with the primary strength scaled by their variance
  // (adjust_strength), chroma along that direction (remapped at 4:2:2 and
  // 4:4:0). Every tap reads the deblocked frame, never a filtered sample, and
  // a tap outside the 8-aligned frame (the mode info grid) is left out; one
  // inside it but past the visible crop is read.

  // cdef_find_dir: the direction of the 8x8 luma block at (y, x) of ``src`` and its variance
  int cdef_direction(const uint16_t* src, int y, int x, int* var) const {
    static const int kDiv[9] = {0, 840, 420, 280, 210, 168, 140, 120, 105};
    int32_t cost[8] = {}, partial[8][15] = {};
    const int shift = seq.bit_depth - 8;
    for (int i = 0; i < 8; ++i) {
      const uint16_t* row = src + (int64_t)(y + i) * stride[0] + x;
      for (int j = 0; j < 8; ++j) {
        int v = (row[j] >> shift) - 128;
        partial[0][i + j] += v;
        partial[1][i + j / 2] += v;
        partial[2][i] += v;
        partial[3][3 + i - j / 2] += v;
        partial[4][7 + i - j] += v;
        partial[5][3 - i / 2 + j] += v;
        partial[6][j] += v;
        partial[7][i / 2 + j] += v;
      }
    }
    for (int i = 0; i < 8; ++i) {
      cost[2] += partial[2][i] * partial[2][i];
      cost[6] += partial[6][i] * partial[6][i];
    }
    cost[2] *= kDiv[8];
    cost[6] *= kDiv[8];
    for (int i = 0; i < 7; ++i) {
      cost[0] += (partial[0][i] * partial[0][i] + partial[0][14 - i] * partial[0][14 - i]) * kDiv[i + 1];
      cost[4] += (partial[4][i] * partial[4][i] + partial[4][14 - i] * partial[4][14 - i]) * kDiv[i + 1];
    }
    cost[0] += partial[0][7] * partial[0][7] * kDiv[8];
    cost[4] += partial[4][7] * partial[4][7] * kDiv[8];
    for (int i = 1; i < 8; i += 2) {
      for (int j = 0; j < 5; ++j) cost[i] += partial[i][3 + j] * partial[i][3 + j];
      cost[i] *= kDiv[8];
      for (int j = 0; j < 3; ++j)
        cost[i] += (partial[i][j] * partial[i][j] + partial[i][10 - j] * partial[i][10 - j]) * kDiv[2 * j + 2];
    }
    int best = 0;
    int32_t best_cost = 0;
    for (int d = 0; d < 8; ++d)
      if (cost[d] > best_cost) { best_cost = cost[d]; best = d; }
    *var = (best_cost - cost[(best + 4) & 7]) >> 10;
    return best;
  }

  // cdef_filter: the block of ``plane`` that the 8x8 luma block at mode info (r, c) covers, from ``src`` into the
  // frame. As libaom's filters do, a tap of strength 0 is not read, and the result is clamped to the taps' range
  // only where both strengths are on: with one, the taps' weights sum to 12 of 16 and the result stays in range.
  void cdef_filter(const uint16_t* src, int plane, int r, int c, int pri, int sec, int damping, int dir) {
    // Cdef_Directions: (row, column) steps of the two taps along each direction
    static const int kDirs[8][2][2] = {{{-1, 1}, {-2, 2}}, {{0, 1}, {-1, 2}}, {{0, 1}, {0, 2}}, {{0, 1}, {1, 2}},
                                       {{1, 1}, {2, 2}},   {{1, 0}, {2, 1}},  {{1, 0}, {2, 0}}, {{1, 0}, {2, -1}}};
    const int shift = seq.bit_depth - 8, sx = ssx(plane), sy = ssy(plane);
    const int x0 = (c * 4) >> sx, y0 = (r * 4) >> sy, w = 8 >> sx, h = 8 >> sy;
    const int64_t st = stride[plane];
    // the taps: (row step, column step, weight, strength, the strength's damping shift (constrain))
    struct Tap { int dy, dx, weight, strength, damp; } taps[12];
    int n = 0;
    for (int k = 0; k < 2; ++k) {
      for (int sign = -1; sign <= 1; sign += 2) {
        if (pri) {
          const int weight = ((pri >> shift) & 1) ? 3 : (k ? 2 : 4);
          taps[n++] = {sign * kDirs[dir][k][0], sign * kDirs[dir][k][1], weight, pri,
                       std::max(0, damping - floor_log2((uint32_t)pri))};
        }
        if (sec) {
          for (int d : {(dir + 2) & 7, (dir + 6) & 7})
            taps[n++] = {sign * kDirs[d][k][0], sign * kDirs[d][k][1], k ? 1 : 2, sec,
                         std::max(0, damping - floor_log2((uint32_t)sec))};
        }
      }
    }
    const bool clamp = pri && sec;
    // whether every tap of the block lies in the 8-aligned frame (taps reach 2 samples)
    const bool inside = x0 >= 2 && y0 >= 2 && x0 + w + 2 <= pw[plane] && y0 + h + 2 <= ph[plane];
    for (int i = 0; i < h; ++i) {
      for (int j = 0; j < w; ++j) {
        const int y = y0 + i, x = x0 + j, v = src[y * st + x];
        int sum = 0, hi = v, lo = v;
        for (int t = 0; t < n; ++t) {
          const int yy = y + taps[t].dy, xx = x + taps[t].dx;
          if (!inside && (yy < 0 || yy >= ph[plane] || xx < 0 || xx >= pw[plane])) continue;
          const int p = src[yy * st + xx], diff = p - v, a = std::abs(diff);
          const int m = std::min(a, std::max(0, taps[t].strength - (a >> taps[t].damp)));  // constrain
          sum += taps[t].weight * (diff < 0 ? -m : m);
          hi = std::max(hi, p);
          lo = std::min(lo, p);
        }
        const int out = v + ((8 + sum - (sum < 0)) >> 4);
        px(plane, y, x) = (uint16_t)(clamp ? std::min(hi, std::max(lo, out)) : out);
      }
    }
  }

  void cdef() {
    if (coded_lossless || !seq.cdef) return;
    bool any = false;
    for (int i = 0; i < (1 << cdef_bits); ++i)
      any = any || cdef_y_pri[i] || cdef_y_sec[i] || cdef_uv_pri[i] || cdef_uv_sec[i];
    if (!any) return;
    // Cdef_Uv_Dir at 4:2:2 (libaom's conv422) and 4:4:0 (conv440)
    static const int kUvDir[2][8] = {{7, 0, 2, 4, 5, 6, 6, 6}, {1, 2, 2, 2, 3, 4, 6, 0}};
    const int shift = seq.bit_depth - 8;
    std::vector<uint16_t>* src = pre_cdef;  // the deblocked planes, which loop restoration reads too
    for (int p = 0; p < planes; ++p) src[p] = frame[p];
    for (int r = 0; r < mi_rows; r += 2) {
      for (int c = 0; c < mi_cols; c += 2) {
        const int idx = cdef(r, c);
        if (idx == -1) continue;
        const uint8_t* sk = &skips[(int64_t)r * mi_cols + c];
        if (sk[0] && sk[1] && sk[mi_cols] && sk[mi_cols + 1]) continue;
        int var = 0;
        const int y_dir = cdef_direction(src[0].data(), 4 * r, 4 * c, &var);
        int pri = cdef_y_pri[idx] << shift, sec = cdef_y_sec[idx] << shift;
        if (pri || sec) {
          // adjust_strength: the primary strength by the block's variance
          const int vs = (var >> 6) ? std::min(floor_log2((uint32_t)(var >> 6)), 12) : 0;
          const int adjusted = var ? (pri * (4 + vs) + 8) >> 4 : 0;
          if (adjusted || sec)
            cdef_filter(src[0].data(), 0, r, c, adjusted, sec, cdef_damping + shift, pri ? y_dir : 0);
        }
        if (planes == 1) continue;
        pri = cdef_uv_pri[idx] << shift;
        sec = cdef_uv_sec[idx] << shift;
        if (!pri && !sec) continue;
        int dir = y_dir;
        if (seq.ssx != seq.ssy) dir = kUvDir[seq.ssx ? 0 : 1][y_dir];
        for (int p = 1; p < 3; ++p)
          cdef_filter(src[p].data(), p, r, c, pri, sec, cdef_damping + shift - 1, pri ? dir : 0);
      }
    }
  }

  // ---- loop restoration (7.17), as libaom's av1_loop_restoration_filter_frame applies it ----
  // A plane whose frame type is not RESTORE_NONE is filtered unit by unit into a new buffer: every tap reads the
  // CDEF'd frame, never a restored sample. The plane is cut into stripes of 64 luma rows, the first 8 rows
  // shorter; a tap above or below its stripe reads the deblocked (pre-CDEF) frame, at most 2 rows past the
  // stripe, and every tap is first clamped to the visible plane (get_source_sample). The last unit of a row or
  // column takes up to 1.5 units.

  void lr_plane(int p) {
    const int sx = ssx(p), sy = ssy(p), bd = seq.bit_depth;
    const int w = (width + sx) >> sx, h = (height + sy) >> sy, size = lr_unit_size[p];
    const int64_t st = stride[p];
    const uint16_t* cdefd = frame[p].data();
    const uint16_t* deblocked = pre_cdef[p].empty() ? cdefd : pre_cdef[p].data();  // CDEF off: the same frame
    std::vector<uint16_t> out = frame[p];
    const int bw = w + 6;  // a stripe's samples with 3 of border each side
    std::vector<int32_t> src((size_t)bw * (64 + 6));
    BoxSums sums;
    for (int n = 0;; ++n) {
      const int start = (64 * n - 8) >> sy, y0 = std::max(0, start);  // StripeStartY, the stripe's first row
      if (y0 >= h) break;
      const int end = std::min(start + (64 >> sy) - 1, h - 1), sh = end + 1 - y0;  // StripeEndY
      for (int i = -3; i < sh + 3; ++i) {
        int y = std::min(h - 1, std::max(0, y0 + i));
        const uint16_t* from = cdefd;
        if (y < start) {
          y = std::max(start - 2, y);
          from = deblocked;
        } else if (y > end) {
          y = std::min(end + 2, y);
          from = deblocked;
        }
        const uint16_t* row = from + y * st;
        int32_t* d = &src[(size_t)(i + 3) * bw + 3];
        for (int x = -3; x < w + 3; ++x) d[x] = row[std::min(w - 1, std::max(0, x))];
      }
      const int32_t* s0 = &src[3 * (size_t)bw + 3];  // the stripe's first row, column 0
      const LrUnit* units = &lr_units[p][(size_t)std::min(lr_rows[p] - 1, ((64 * n) >> sy) / size) * lr_cols[p]];
      sums.reset(s0, bw, w, sh);
      for (int uc = 0; uc < lr_cols[p]; ++uc) {
        const int x0 = uc * size, x1 = uc == lr_cols[p] - 1 ? w : x0 + size;
        uint16_t* o = &out[(size_t)y0 * st + x0];
        if (units[uc].type == kRestoreWiener) {
          lr_wiener(units[uc], s0 + x0, bw, x1 - x0, sh, bd, o, st);
        } else if (units[uc].type == kRestoreSgrproj) {
          lr_sgrproj(units[uc], s0, bw, sums, x0, x1, sh, y0, bd, o, st);
        }
      }
    }
    frame[p].swap(out);
  }

  // av1_wiener_convolve_add_src: the horizontal filter into an intermediate clamped to its range, then the vertical
  // one (the 7 taps c0 c1 c2 128-2(c0+c1+c2) c2 c1 c0) of w x h samples from s (the top-left; row stride bw)
  static void lr_wiener(const LrUnit& u, const int32_t* s, int bw, int w, int h, int bd, uint16_t* o, int64_t st) {
    const int r0 = bd == 12 ? 5 : 3, r1 = bd == 12 ? 9 : 11;  // InterRound0, InterRound1
    int f[2][7];
    for (int pass = 0; pass < 2; ++pass) {
      const int8_t* c = u.wiener[pass];
      const int taps[7] = {c[0], c[1], c[2], 128 - 2 * (c[0] + c[1] + c[2]), c[2], c[1], c[0]};
      std::memcpy(f[pass], taps, sizeof taps);
    }
    const int limit = (1 << (bd + 8 - r0)) - 1, maxv = (1 << bd) - 1;
    std::vector<int32_t> mid((size_t)(h + 6) * w);
    for (int i = 0; i < h + 6; ++i) {
      const int32_t* row = s + (int64_t)(i - 3) * bw - 3;
      int32_t* m = &mid[(size_t)i * w];
      for (int x = 0; x < w; ++x) {
        int32_t sum = (1 << (bd + 6)) + (1 << (r0 - 1));
        for (int k = 0; k < 7; ++k) sum += f[1][k] * row[x + k];
        m[x] = std::min(limit, std::max(0, sum >> r0));
      }
    }
    for (int i = 0; i < h; ++i) {
      for (int x = 0; x < w; ++x) {
        int32_t sum = (1 << (r1 - 1)) - (1 << (bd + r1 - 1));
        for (int k = 0; k < 7; ++k) sum += f[0][k] * mid[(size_t)(i + k) * w + x];
        o[i * st + x] = (uint16_t)std::min(maxv, std::max(0, sum >> r1));
      }
    }
  }

  // The box sums of a stripe (libaom's boxsum): per radius (1 or 2, filled when first asked for), the sum and the
  // sum of squares of the (2r+1)^2 samples around each position of rows -1 .. h and columns -1 .. w, running sums
  // down the columns, then along the rows.
  struct BoxSums {
    const int32_t* s = nullptr;  // the stripe's row 0, column 0 (row stride bw)
    int bw = 0, w = 0, h = 0;
    bool ready[2] = {false, false};
    std::vector<uint32_t> sum[2], sq[2], vs, vq;  // [radius - 1], (h + 2) rows of (w + 2)
    void reset(const int32_t* src, int stride, int width, int height) {
      s = src;
      bw = stride;
      w = width;
      h = height;
      ready[0] = ready[1] = false;
    }
    void fill(int r) {
      ready[r - 1] = true;
      const int cols = w + 6;  // the columns -3 .. w + 2 of the vertical sums
      vs.assign(cols, 0u);
      vq.assign(cols, 0u);
      sum[r - 1].resize((size_t)(h + 2) * (w + 2));
      sq[r - 1].resize((size_t)(h + 2) * (w + 2));
      for (int dy = -r; dy < r; ++dy) {  // rows -1 - r .. r - 2: row -1's window but its last row
        const int32_t* row = s + (int64_t)(dy - 1) * bw - 3;
        for (int x = 0; x < cols; ++x) {
          vs[x] += (uint32_t)row[x];
          vq[x] += (uint32_t)(row[x] * row[x]);
        }
      }
      for (int i = -1; i <= h; ++i) {
        const int32_t* add = s + (int64_t)(i + r) * bw - 3;
        for (int x = 0; x < cols; ++x) {
          vs[x] += (uint32_t)add[x];
          vq[x] += (uint32_t)(add[x] * add[x]);
        }
        uint32_t* os = &sum[r - 1][(size_t)(i + 1) * (w + 2)];
        uint32_t* oq = &sq[r - 1][(size_t)(i + 1) * (w + 2)];
        uint32_t a = 0, b = 0;  // the running sums over the 2r+1 columns ending at x + r
        for (int x = 3 - 1 - r; x < 3 - 1 + r; ++x) {
          a += vs[x];
          b += vq[x];
        }
        for (int j = 0; j < w + 2; ++j) {  // column j - 1
          a += vs[j + 2 + r];
          b += vq[j + 2 + r];
          os[j] = a;
          oq[j] = b;
          a -= vs[j + 2 - r];
          b -= vq[j + 2 - r];
        }
        const int32_t* drop = s + (int64_t)(i - r) * bw - 3;
        for (int x = 0; x < cols; ++x) {
          vs[x] -= (uint32_t)drop[x];
          vq[x] -= (uint32_t)(drop[x] * drop[x]);
        }
      }
    }
  };

  // av1_apply_selfguided_restoration: the box filters of radius r0 (A and B on every other row, weights 6 and 5)
  // and r1 (weights 4 and 3) of the set, projected with xqd, for columns x0 .. x1 of the stripe's h rows
  static void lr_sgrproj(const LrUnit& u, const int32_t* s, int bw, BoxSums& sums, int x0, int x1, int h, int y0,
                         int bd, uint16_t* o, int64_t st) {
    const int32_t* prm = av1t::kSgrParams[u.set];  // r0, r1, s0, s1
    const int w = x1 - x0, maxv = (1 << bd) - 1;
    std::vector<int32_t> flt[2];
    std::vector<int32_t> a_((size_t)(h + 2) * (w + 2)), b_((size_t)(h + 2) * (w + 2));
    for (int pass = 0; pass < 2; ++pass) {
      const int r = prm[pass];
      if (!r) continue;
      // calc_ab: A and B at rows -1 .. h and columns x0 - 1 .. x1 (radius 2: the odd rows only are read)
      const uint32_t n = (2 * r + 1) * (2 * r + 1), sc = (uint32_t)prm[2 + pass], one_by_n = av1t::kOneByX[n - 1];
      if (!sums.ready[r - 1]) sums.fill(r);
      const uint32_t* bsum = sums.sum[r - 1].data();
      const uint32_t* bsq = sums.sq[r - 1].data();
      // radius 2 reads A and B on the odd rows alone (y0 is even: a_ row i is row y0 + i - 1)
      for (int i = 0; i < h + 2; i += r == 2 ? 2 : 1) {
        for (int j = 0; j < w + 2; ++j) {
          const size_t k = (size_t)i * (sums.w + 2) + x0 + j, l = (size_t)i * (w + 2) + j;
          const uint32_t a = (bsq[k] + ((1u << (2 * (bd - 8))) >> 1)) >> (2 * (bd - 8));
          const uint32_t b = (bsum[k] + ((1u << (bd - 8)) >> 1)) >> (bd - 8);
          const uint32_t p = a * n < b * b ? 0 : a * n - b * b;
          const uint32_t z = (p * sc + (1u << 19)) >> 20;
          const int32_t aa = av1t::kXByXplus1[std::min(z, 255u)];
          a_[l] = aa;
          b_[l] = (int32_t)(((uint32_t)(256 - aa) * bsum[k] * one_by_n + (1u << 11)) >> 12);
        }
      }
      flt[pass].resize((size_t)h * w);
      const int ws = w + 2;
      for (int i = 0; i < h; ++i) {
        const int32_t* sr = s + (int64_t)i * bw + x0;
        for (int j = 0; j < w; ++j) {
          const size_t k = (size_t)(i + 1) * ws + j + 1;
          int32_t a, b, nb = 5;
          if (r == 2) {
            if (!((y0 + i) & 1)) {  // the rows above and below
              a = (a_[k - ws] + a_[k + ws]) * 6 + (a_[k - 1 - ws] + a_[k - 1 + ws] + a_[k + 1 - ws] + a_[k + 1 + ws]) * 5;
              b = (b_[k - ws] + b_[k + ws]) * 6 + (b_[k - 1 - ws] + b_[k - 1 + ws] + b_[k + 1 - ws] + b_[k + 1 + ws]) * 5;
            } else {
              a = a_[k] * 6 + (a_[k - 1] + a_[k + 1]) * 5;
              b = b_[k] * 6 + (b_[k - 1] + b_[k + 1]) * 5;
              nb = 4;
            }
          } else {
            a = (a_[k] + a_[k - 1] + a_[k + 1] + a_[k - ws] + a_[k + ws]) * 4 +
                (a_[k - 1 - ws] + a_[k - 1 + ws] + a_[k + 1 - ws] + a_[k + 1 + ws]) * 3;
            b = (b_[k] + b_[k - 1] + b_[k + 1] + b_[k - ws] + b_[k + ws]) * 4 +
                (b_[k - 1 - ws] + b_[k - 1 + ws] + b_[k + 1 - ws] + b_[k + 1 + ws]) * 3;
          }
          const int32_t v = a * sr[j] + b, shift = 8 + nb - 4;  // SGRPROJ_SGR_BITS + nb - SGRPROJ_RST_BITS
          flt[pass][(size_t)i * w + j] = (v + (1 << (shift - 1))) >> shift;
        }
      }
    }
    // av1_decode_xq, then the projection at SGRPROJ_RST_BITS 4 and SGRPROJ_PRJ_BITS 7
    int xq0 = u.xqd[0], xq1 = (1 << 7) - xq0 - u.xqd[1];
    if (!prm[0]) {
      xq0 = 0;
      xq1 = (1 << 7) - u.xqd[1];
    } else if (!prm[1]) {
      xq1 = 0;
    }
    for (int i = 0; i < h; ++i) {
      const int32_t* sr = s + (int64_t)i * bw + x0;
      for (int j = 0; j < w; ++j) {
        const int32_t uu = sr[j] << 4;
        int32_t v = uu << 7;
        if (prm[0]) v += xq0 * (flt[0][(size_t)i * w + j] - uu);
        if (prm[1]) v += xq1 * (flt[1][(size_t)i * w + j] - uu);
        const int16_t out = (int16_t)((v + (1 << 10)) >> 11);
        o[i * st + j] = (uint16_t)std::min<int>(maxv, std::max<int>(0, out));
      }
    }
  }
};

}  // namespace

extern "C" {

static thread_local Decoder* g_last = nullptr;

// An AV1 payload (a sequence of OBUs, as an AVIF item holds it) -> status:
// 0 decoded (av1_planes copies the planes), -1 a stream libaom fails on
// (meta[4] minus the source line that found it; 0 where memory ran out),
// -2 a tool this decoder does not have (meta[4]), -3 a frame past
// libavif's size limits (meta[0], meta[1]). meta: width, height, bit depth,
// planes, tool, colour range, matrix coefficients, colour primaries,
// transfer characteristics, subsampling x, subsampling y, then what the
// palettes coded: a bit per palette size (1 << n) of Y, of UV, the colours
// taken from a cache, the V colours coded as deltas; then what intra block
// copy coded: its blocks, those whose DV stack held a candidate, a bit per
// path taken (Decoder::kPath*: half-pixel chroma across and down, a split
// at transform depth 0 and 1, inter transform sets 1, 2, 3, the default DV
// a superblock up and one left); then what delta LF coded: the blocks whose
// deltas are not all 0, a bit per path taken (Decoder::kLf*: deltas per plane
// and direction, a multiplier above 1, a delta clamped, an edge filtered in a
// pass at level 0, a tile reset); then what segmentation coded: a bit per
// segment id a block took, a bit per path taken (Decoder::kSeg*).
int av1_decode(const uint8_t* src, int64_t n, int32_t* meta) {
  delete g_last;
  for (int i = 0; i < 22; ++i) meta[i] = 0;
  g_last = new (std::nothrow) Decoder();
  if (!g_last) return -1;
  Decoder& d = *g_last;
  try {
    d.decode(src, n);
  } catch (const Corrupt& c) {
    meta[4] = -c.line;
    return -1;
  } catch (const Unsupported& u) {
    meta[4] = u.tool;
    return -2;
  } catch (const TooLarge&) {
    meta[0] = d.width; meta[1] = d.height;
    return -3;
  } catch (const std::bad_alloc&) {
    return -1;
  }
  meta[0] = d.width; meta[1] = d.height; meta[2] = d.seq.bit_depth; meta[3] = d.planes;
  meta[5] = d.seq.range; meta[6] = d.seq.mc; meta[7] = d.seq.cp; meta[8] = d.seq.tc;
  meta[9] = d.seq.ssx; meta[10] = d.seq.ssy;
  meta[11] = d.palette_y_sizes; meta[12] = d.palette_uv_sizes; meta[13] = d.palette_cached;
  meta[14] = d.palette_v_deltas;
  meta[15] = d.intrabc_blocks; meta[16] = d.intrabc_stacked; meta[17] = d.intrabc_paths;
  meta[18] = d.delta_lf_blocks; meta[19] = d.delta_lf_paths;
  meta[20] = d.seg_ids_used; meta[21] = d.seg_paths;
  return 0;
}

// libyuv's conversion of Y, U, V (uint16 samples, the top 8 of ``depth``
// bits taken, as libavif's Convert16To8Plane does) to BGR as
// I4xxToRGB24MatrixFilter makes it: chroma of w x h luma samples upsampled
// (4:2:0 bilinear, 9:3:3:1 across two rows and 3:1 along one at the edges;
// 4:2:2 linear, 3:1; the first and last columns held), then YuvPixel with
// constants k = YG, YB, UB, UG, VG, VR in 6-bit fixed point. cw x ch is the
// chroma size.
void yuv_to_bgr_libyuv(const uint16_t* y, const uint16_t* u, const uint16_t* v, int w, int h, int cw, int ch,
                       int depth, const int32_t* k, uint8_t* out) {
  const int shift = depth - 8;
  const int yg = k[0], yb = k[1], ub = k[2], ug = k[3], vg = k[4], vr = k[5];
  const bool sx = cw != w, sy = ch != h;
  std::vector<int32_t> ur(w), vr_(w), tmp_a(cw), tmp_b(cw);
  // one output row of a chroma plane from its chroma row(s) a (and b, two-row bilinear)
  auto across = [&](const uint16_t* a, const uint16_t* b, int32_t* dst) {
    for (int i = 0; i < cw; ++i) {
      tmp_a[i] = a[i] >> shift;
      if (b) tmp_b[i] = b[i] >> shift;
    }
    if (!sx) {
      for (int i = 0; i < w; ++i) dst[i] = b ? (3 * tmp_a[i] + tmp_b[i] + 2) >> 2 : tmp_a[i];
      return;
    }
    const int last = (w - 1) / 2;
    for (int j = 1; j < w - 1; ++j) {
      int k0 = (j - 1) / 2, near = (j & 1) ? k0 : k0 + 1, far = (j & 1) ? k0 + 1 : k0;
      dst[j] = b ? (9 * tmp_a[near] + 3 * tmp_a[far] + 3 * tmp_b[near] + tmp_b[far] + 8) >> 4
                 : (3 * tmp_a[near] + tmp_a[far] + 2) >> 2;
    }
    dst[0] = b ? (3 * tmp_a[0] + tmp_b[0] + 2) >> 2 : tmp_a[0];
    dst[w - 1] = b ? (3 * tmp_a[last] + tmp_b[last] + 2) >> 2 : tmp_a[last];
  };
  for (int r = 0; r < h; ++r) {
    const uint16_t *ua, *ub_ = nullptr, *va, *vb = nullptr;
    if (!sy) {
      ua = u + (int64_t)r * cw;
      va = v + (int64_t)r * cw;
    } else if (r == 0 || (h % 2 == 0 && r == h - 1)) {
      int c = (r == 0) ? 0 : (h - 1) / 2;
      ua = u + (int64_t)c * cw;
      va = v + (int64_t)c * cw;
    } else {
      int kk = (r - 1) / 2, near = (r & 1) ? kk : kk + 1, far = (r & 1) ? kk + 1 : kk;
      ua = u + (int64_t)near * cw;
      ub_ = u + (int64_t)far * cw;
      va = v + (int64_t)near * cw;
      vb = v + (int64_t)far * cw;
    }
    across(ua, ub_, ur.data());
    across(va, vb, vr_.data());
    const uint16_t* yr = y + (int64_t)r * w;
    uint8_t* o = out + (int64_t)r * w * 3;
    for (int i = 0; i < w; ++i) {
      int32_t y1 = (int32_t)(((uint32_t)(yr[i] >> shift) * 0x0101u * (uint32_t)yg) >> 16) + yb;
      int32_t uu = ur[i] - 128, vv = vr_[i] - 128;
      int32_t b = (y1 + uu * ub) >> 6, g = (y1 - (uu * ug + vv * vg)) >> 6, rr = (y1 + vv * vr) >> 6;
      o[3 * i] = (uint8_t)(b < 0 ? 0 : b > 255 ? 255 : b);
      o[3 * i + 1] = (uint8_t)(g < 0 ? 0 : g > 255 ? 255 : g);
      o[3 * i + 2] = (uint8_t)(rr < 0 ? 0 : rr > 255 ? 255 : rr);
    }
  }
}

// 7.13.3 on its own: the dequantized coefficients of a transform of size
// ``tx`` (the specification's TxSize; the coded top-left part, at most 32x32,
// row-major) and type ``tx_type`` (the 16 of the specification, DCT_DCT ..
// H_FLIPADST) at ``bd`` bits -> the residual, tx height rows of tx width; -1
// for a size or type no transform set pairs.
int av1_inverse_transform(const int32_t* coef, int tx, int tx_type, int bd, int32_t* out) {
  if (tx < 0 || tx > 18 || tx_type < 0 || tx_type > H_FLIPADST) return -1;
  const int w = tx_w(tx), h = tx_h(tx);
  const bool adst = (tx_type >= ADST_DCT && tx_type <= FLIPADST_ADST) || tx_type >= V_ADST, one_d = tx_type >= V_DCT;
  if ((adst || one_d) && std::max(w, h) > 16) return -1;
  if (tx_type == IDTX && std::max(w, h) > 32) return -1;
  inverse_transform_2d(coef, tx, tx_type, bd, out);
  return 0;
}

// The planes of the last av1_decode of this thread into out: Y (height
// rows of width samples), then U and V (each ((height + ssy) >> ssy) rows of
// ((width + ssx) >> ssx) samples); -1 if out is too small.
int av1_planes(uint16_t* out, int64_t cap) {
  if (!g_last) return -1;
  Decoder& d = *g_last;
  int64_t need = 0;
  for (int p = 0; p < d.planes; ++p)
    need += (int64_t)((d.width + d.ssx(p)) >> d.ssx(p)) * ((d.height + d.ssy(p)) >> d.ssy(p));
  if (cap < need) return -1;
  for (int p = 0; p < d.planes; ++p) {
    int w = (d.width + d.ssx(p)) >> d.ssx(p), h = (d.height + d.ssy(p)) >> d.ssy(p);
    for (int y = 0; y < h; ++y, out += w) std::memcpy(out, &d.frame[p][(int64_t)y * d.stride[p]], sizeof(uint16_t) * w);
  }
  delete g_last;
  g_last = nullptr;
  return 0;
}

}  // extern "C"
