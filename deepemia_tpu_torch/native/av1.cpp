// A decoder of the AV1 still pictures that libaom writes losslessly, as
// libavif hands them to libaom (AV1 specification, 2019 with errata):
// the OBU layer (sequence headers, full and reduced; temporal delimiter,
// frame, frame header and tile group OBUs; padding and metadata skipped),
// the uncompressed header of a shown key frame, tile info (uniform and
// not), the symbol decoder with CDF adaptation, partitions of 64x64 and
// 128x128 superblocks down to 4x4, intra mode info (skip, Y mode, angle
// delta, UV mode with CFL, filter intra), TX_4X4 coefficients at
// q-context 0 with the inverse Walsh-Hadamard transform, and intra
// prediction (DC, V, H, the directional modes with the edge filter and
// upsampling, smooth, Paeth, CFL, recursive filter intra), at 8, 10 and 12
// bits in 4:4:4 or 4:0:0. A stream that uses any other tool is refused
// with the tool's number (kTool*), never decoded wrong.
//
// Where libaom fails on a damaged stream, so does this decoder: a tile
// whose symbols run past its data at the end of a superblock
// (aom_reader_has_overflowed), a Golomb code longer than 20 bits, an OBU
// larger than its data, a sequence or frame header whose trailing bits are
// not a one and zeros.
//
// Built by ``native/__init__.py`` with g++ at first use; the entry point is
// av1_decode.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <new>
#include <vector>

namespace {

// The default CDFs of the AV1 specification (section 9.4) that a lossless key
// frame reads, in the specification's form: N cumulative values ending in
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
// the coefficient CDFs of TX_4X4 at q-context 0 (base_q_idx <= 20)
static const uint16_t kTxbSkip[13][3] = {
  {31849, 32768, 0},
  {5892, 32768, 0},
  {12112, 32768, 0},
  {21935, 32768, 0},
  {20289, 32768, 0},
  {27473, 32768, 0},
  {32487, 32768, 0},
  {7654, 32768, 0},
  {19473, 32768, 0},
  {29984, 32768, 0},
  {9961, 32768, 0},
  {30242, 32768, 0},
  {32117, 32768, 0}};
static const uint16_t kEobPt16[4][6] = {
  {840, 1039, 1980, 4895, 32768, 0},
  {370, 671, 1883, 4471, 32768, 0},
  {3247, 4950, 9688, 14563, 32768, 0},
  {1904, 3354, 7763, 14647, 32768, 0}};
static const uint16_t kEobExtra[18][3] = {
  {16961, 32768, 0},
  {17223, 32768, 0},
  {7621, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {19069, 32768, 0},
  {22525, 32768, 0},
  {13377, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0},
  {16384, 32768, 0}};
static const uint16_t kCoeffBaseEob[8][4] = {
  {17837, 29055, 32768, 0},
  {29600, 31446, 32768, 0},
  {30844, 31878, 32768, 0},
  {24926, 28948, 32768, 0},
  {21365, 30026, 32768, 0},
  {30512, 32423, 32768, 0},
  {31658, 32621, 32768, 0},
  {29630, 31881, 32768, 0}};
static const uint16_t kCoeffBase[84][5] = {
  {4034, 8930, 12727, 32768, 0},
  {18082, 29741, 31877, 32768, 0},
  {12596, 26124, 30493, 32768, 0},
  {9446, 21118, 27005, 32768, 0},
  {6308, 15141, 21279, 32768, 0},
  {2463, 6357, 9783, 32768, 0},
  {20667, 30546, 31929, 32768, 0},
  {13043, 26123, 30134, 32768, 0},
  {8151, 18757, 24778, 32768, 0},
  {5255, 12839, 18632, 32768, 0},
  {2820, 7206, 11161, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {15736, 27553, 30604, 32768, 0},
  {11210, 23794, 28787, 32768, 0},
  {5947, 13874, 19701, 32768, 0},
  {4215, 9323, 13891, 32768, 0},
  {2833, 6462, 10059, 32768, 0},
  {19605, 30393, 31582, 32768, 0},
  {13523, 26252, 30248, 32768, 0},
  {8446, 18622, 24512, 32768, 0},
  {3818, 10343, 15974, 32768, 0},
  {1481, 4117, 6796, 32768, 0},
  {22649, 31302, 32190, 32768, 0},
  {14829, 27127, 30449, 32768, 0},
  {8313, 17702, 23304, 32768, 0},
  {3022, 8301, 12786, 32768, 0},
  {1536, 4412, 7184, 32768, 0},
  {22354, 29774, 31372, 32768, 0},
  {14723, 25472, 29214, 32768, 0},
  {6673, 13745, 18662, 32768, 0},
  {2068, 5766, 9322, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {6302, 16444, 21761, 32768, 0},
  {23040, 31538, 32475, 32768, 0},
  {15196, 28452, 31496, 32768, 0},
  {10020, 22946, 28514, 32768, 0},
  {6533, 16862, 23501, 32768, 0},
  {3538, 9816, 15076, 32768, 0},
  {24444, 31875, 32525, 32768, 0},
  {15881, 28924, 31635, 32768, 0},
  {9922, 22873, 28466, 32768, 0},
  {6527, 16966, 23691, 32768, 0},
  {4114, 11303, 17220, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {20201, 30770, 32209, 32768, 0},
  {14754, 28071, 31258, 32768, 0},
  {8378, 20186, 26517, 32768, 0},
  {5916, 15299, 21978, 32768, 0},
  {4268, 11583, 17901, 32768, 0},
  {24361, 32025, 32581, 32768, 0},
  {18673, 30105, 31943, 32768, 0},
  {10196, 22244, 27576, 32768, 0},
  {5495, 14349, 20417, 32768, 0},
  {2676, 7415, 11498, 32768, 0},
  {24678, 31958, 32585, 32768, 0},
  {18629, 29906, 31831, 32768, 0},
  {9364, 20724, 26315, 32768, 0},
  {4641, 12318, 18094, 32768, 0},
  {2758, 7387, 11579, 32768, 0},
  {25433, 31842, 32469, 32768, 0},
  {18795, 29289, 31411, 32768, 0},
  {7644, 17584, 23592, 32768, 0},
  {3408, 9014, 15047, 32768, 0},
  {8192, 16384, 24576, 32768, 0},
  {8192, 16384, 24576, 32768, 0}};
static const uint16_t kCoeffBr[42][5] = {
  {14298, 20718, 24174, 32768, 0},
  {12536, 19601, 23789, 32768, 0},
  {8712, 15051, 19503, 32768, 0},
  {6170, 11327, 15434, 32768, 0},
  {4742, 8926, 12538, 32768, 0},
  {3803, 7317, 10546, 32768, 0},
  {1696, 3317, 4871, 32768, 0},
  {14392, 19951, 22756, 32768, 0},
  {15978, 23218, 26818, 32768, 0},
  {12187, 19474, 23889, 32768, 0},
  {9176, 15640, 20259, 32768, 0},
  {7068, 12655, 17028, 32768, 0},
  {5656, 10442, 14472, 32768, 0},
  {2580, 4992, 7244, 32768, 0},
  {12136, 18049, 21426, 32768, 0},
  {13784, 20721, 24481, 32768, 0},
  {10836, 17621, 21900, 32768, 0},
  {8372, 14444, 18847, 32768, 0},
  {6523, 11779, 16000, 32768, 0},
  {5337, 9898, 13760, 32768, 0},
  {3034, 5860, 8462, 32768, 0},
  {15967, 22905, 26286, 32768, 0},
  {13534, 20654, 24579, 32768, 0},
  {9504, 16092, 20535, 32768, 0},
  {6975, 12568, 16903, 32768, 0},
  {5364, 10091, 14020, 32768, 0},
  {4357, 8370, 11857, 32768, 0},
  {2506, 4934, 7218, 32768, 0},
  {23032, 28815, 30936, 32768, 0},
  {19540, 26704, 29719, 32768, 0},
  {15158, 22969, 27097, 32768, 0},
  {11408, 18865, 23650, 32768, 0},
  {8885, 15448, 20250, 32768, 0},
  {7108, 12853, 17416, 32768, 0},
  {4231, 8041, 11480, 32768, 0},
  {19823, 26490, 29156, 32768, 0},
  {18890, 25929, 28932, 32768, 0},
  {15660, 23491, 27433, 32768, 0},
  {12147, 19776, 24488, 32768, 0},
  {9728, 16774, 21649, 32768, 0},
  {7919, 14277, 19066, 32768, 0},
  {5440, 10170, 14185, 32768, 0}};
static const uint16_t kDcSign[2][3][3] = {{{16000, 32768, 0}, {13056, 32768, 0}, {18816, 32768, 0}},
  {{15232, 32768, 0}, {12928, 32768, 0}, {17280, 32768, 0}}};

static const uint8_t kSmWeights4[4] = {255, 149, 85, 64};
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
static const int kDefaultScan4x4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
static const int kCoeffBaseCtxOffset4x4[5][5] = {
    {0, 1, 6, 6, 0}, {1, 6, 6, 21, 0}, {6, 6, 21, 21, 0}, {6, 21, 21, 21, 0}, {0, 0, 0, 0, 0}};

// block sizes, in the specification's order
enum { B4X4, B4X8, B8X4, B8X8, B8X16, B16X8, B16X16, B16X32, B32X16, B32X32, B32X64, B64X32, B64X64,
       B64X128, B128X64, B128X128, B4X16, B16X4, B8X32, B32X8, B16X64, B64X16, BLOCK_INVALID };
static const int kWide4[22] = {1, 1, 2, 2, 2, 4, 4, 4, 8, 8, 8, 16, 16, 16, 32, 32, 1, 4, 2, 8, 4, 16};
static const int kHigh4[22] = {1, 2, 1, 2, 4, 2, 4, 8, 4, 8, 16, 8, 16, 32, 16, 32, 4, 1, 8, 2, 16, 4};
enum { P_NONE, P_HORZ, P_VERT, P_SPLIT, P_HORZ_A, P_HORZ_B, P_VERT_A, P_VERT_B, P_HORZ_4, P_VERT_4 };
enum { DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, D113_PRED, D157_PRED, D203_PRED, D67_PRED, SMOOTH_PRED,
       SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, UV_CFL_PRED };

}  // namespace

// What a refusal names (meta[4]); ops/avif.py holds the names
enum Tool {
  kToolLossy = 1, kToolSubsampling = 2, kToolSegmentation = 3, kToolScreenContent = 4,
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

int floor_log2(uint32_t x) {
  int s = 0;
  while (x > 1) { x >>= 1; ++s; }
  return s;
}

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
  uint32_t bits(int n) {
    uint32_t x = 0;
    for (int i = 0; i < n; ++i) {
      int64_t b = pos++;
      x = (x << 1) | ((b >> 3) < size ? (p[b >> 3] >> (7 - (b & 7))) & 1 : 0);
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
  uint16_t txb_skip[13][3], eob16[2][2][6], eob_extra[2][9][3], base_eob[2][4][4], base[2][42][5], br[2][21][5];
  uint16_t dc_sign[2][3][3];
  void reset() {
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
    std::memcpy(txb_skip, kTxbSkip, sizeof txb_skip);
    std::memcpy(eob16, kEobPt16, sizeof eob16);
    std::memcpy(eob_extra, kEobExtra, sizeof eob_extra);
    std::memcpy(base_eob, kCoeffBaseEob, sizeof base_eob);
    std::memcpy(base, kCoeffBase, sizeof base);
    std::memcpy(br, kCoeffBr, sizeof br);
    std::memcpy(dc_sign, kDcSign, sizeof dc_sign);
  }
};

// ---------------------------------------------------------------------------
// The decoder
// ---------------------------------------------------------------------------

struct Decoder {
  Sequence seq;
  // the frame header
  int width = 0, height = 0, mi_cols = 0, mi_rows = 0;
  int disable_cdf_update = 0;
  int tile_cols = 0, tile_rows = 0, tile_cols_log2 = 0, tile_rows_log2 = 0, tile_size_bytes = 0;
  std::vector<int> mi_col_starts, mi_row_starts;
  bool seen_frame_header = false, decoded = false;
  int next_tile = 0;
  Cdfs frame_cdfs, cdf;
  // the frame: planes of (mi_cols * 4) x (mi_rows * 4) samples
  int planes = 0, stride = 0;
  std::vector<uint16_t> frame[3];
  // per 4x4 unit of the frame
  std::vector<uint8_t> y_modes, uv_modes, mi_sizes, skips;
  // coefficient contexts, per plane
  std::vector<uint8_t> above_level[3], above_dc[3], left_level[3], left_dc[3];
  uint8_t block_decoded_[3][34][34];
  // the tile
  int mi_row_start, mi_row_end, mi_col_start, mi_col_end;
  Symbol sym;
  // the block
  int mi_row, mi_col, mi_size, has_chroma, avail_u, avail_l, skip, y_mode, uv_mode, angle_y, angle_uv;
  int use_filter_intra, filter_intra_mode, cfl_alpha_u, cfl_alpha_v;

  uint8_t& block_decoded(int plane, int r, int c) { return block_decoded_[plane][r + 1][c + 1]; }
  uint16_t& px(int plane, int y, int x) { return frame[plane][(int64_t)y * stride + x]; }

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
    if (!s.mono && (s.ssx || s.ssy)) throw Unsupported{kToolSubsampling};
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
    int screen = seq.force_screen_content == 2 ? b.f(1) : seq.force_screen_content;
    if (screen) throw Unsupported{kToolScreenContent};
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
    mi_cols = 2 * ((width + 7) >> 3);
    mi_rows = 2 * ((height + 7) >> 3);
    // disable_frame_end_update_cdf
    if (!seq.reduced && !disable_cdf_update) b.f(1);
    tile_info(b);
    // quantization_params
    int base_q = b.f(8);
    auto delta_q = [&]() { return b.f(1) ? b.su(7) : 0; };
    int dq = delta_q();
    if (seq.mono == 0) {
      int diff = seq.separate_uv_delta_q ? b.f(1) : 0;
      dq |= delta_q(); dq |= delta_q();
      if (diff) { dq |= delta_q(); dq |= delta_q(); }
    }
    if (base_q != 0 || dq != 0) throw Unsupported{kToolLossy};
    if (b.f(1)) {  // using_qmatrix: qm_y, qm_u (and qm_v), which a lossless block does not apply
      b.f(4); b.f(4);
      if (seq.separate_uv_delta_q) b.f(4);
    }
    if (b.f(1)) throw Unsupported{kToolSegmentation};  // segmentation_enabled
    // delta_q_params, delta_lf_params: not read at base_q_idx 0; loop filter, CDEF and loop restoration
    // parameters: not read in a coded-lossless frame; tx_mode: ONLY_4X4; reference mode: intra
    b.f(1);  // reduced_tx_set
    if (seq.film_grain && b.f(1)) throw Unsupported{kToolFilmGrain};  // apply_grain
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
    stride = mi_cols * 4;
    for (int p = 0; p < planes; ++p) frame[p].assign((size_t)stride * mi_rows * 4, 0);
    size_t n = (size_t)mi_cols * mi_rows;
    y_modes.assign(n, 0); uv_modes.assign(n, 0); mi_sizes.assign(n, 0); skips.assign(n, 0);
    for (int p = 0; p < 3; ++p) {
      above_level[p].assign(mi_cols + 32, 0); above_dc[p].assign(mi_cols + 32, 0);
      left_level[p].assign(mi_rows + 32, 0); left_dc[p].assign(mi_rows + 32, 0);
    }
    frame_cdfs.reset();
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
    int sb4 = seq.sb128 ? 32 : 16;
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < planes; ++p) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        clear_block_decoded(r, c, sb4);
        decode_partition(r, c, seq.sb128 ? B128X128 : B64X64);
        if (sym.overflowed()) throw Corrupt{__LINE__};
      }
    }
    if (!sym.trailing_ok()) throw Corrupt{__LINE__};
  }

  void clear_block_decoded(int r, int c, int sb4) {
    for (int p = 0; p < planes; ++p) {
      int w4 = mi_col_end - c, h4 = mi_row_end - r;
      for (int y = -1; y <= sb4; ++y)
        for (int x = -1; x <= sb4; ++x)
          block_decoded(p, y, x) = (y < 0 && x < w4) || (x < 0 && y < h4);
      block_decoded(p, sb4, -1) = 0;
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
    switch (partition) {
      case P_NONE: decode_block(r, c, sub); break;
      case P_HORZ:
        decode_block(r, c, sub);
        if (has_rows) decode_block(r + half, c, sub);
        break;
      case P_VERT:
        decode_block(r, c, sub);
        if (has_cols) decode_block(r, c + half, sub);
        break;
      case P_SPLIT:
        decode_partition(r, c, sub);
        decode_partition(r, c + half, sub);
        decode_partition(r + half, c, sub);
        decode_partition(r + half, c + half, sub);
        break;
      case P_HORZ_A:
        decode_block(r, c, split); decode_block(r, c + half, split); decode_block(r + half, c, sub);
        break;
      case P_HORZ_B:
        decode_block(r, c, sub); decode_block(r + half, c, split); decode_block(r + half, c + half, split);
        break;
      case P_VERT_A:
        decode_block(r, c, split); decode_block(r + half, c, split); decode_block(r, c + half, sub);
        break;
      case P_VERT_B:
        decode_block(r, c, sub); decode_block(r, c + half, split); decode_block(r + half, c + half, split);
        break;
      case P_HORZ_4:
        for (int i = 0; i < 4; ++i)
          if (i < 3 || r + quarter * 3 < mi_rows) decode_block(r + quarter * i, c, sub);
        break;
      case P_VERT_4:
        for (int i = 0; i < 4; ++i)
          if (i < 3 || c + quarter * 3 < mi_cols) decode_block(r, c + quarter * i, sub);
        break;
    }
  }

  // ---- a block (5.11.5) ----
  void decode_block(int r, int c, int bsize) {
    mi_row = r; mi_col = c; mi_size = bsize;
    int bw4 = kWide4[bsize], bh4 = kHigh4[bsize];
    has_chroma = planes > 1;
    avail_u = inside(r - 1, c);
    avail_l = inside(r, c - 1);
    intra_frame_mode_info();
    if (skip) {
      for (int p = 0; p < 1 + 2 * has_chroma; ++p) {
        for (int i = c; i < c + bw4; ++i) { above_level[p][i] = 0; above_dc[p][i] = 0; }
        for (int i = r; i < r + bh4; ++i) { left_level[p][i] = 0; left_dc[p][i] = 0; }
      }
    }
    for (int y = 0; y < bh4; ++y) {
      if (r + y >= mi_rows) break;
      for (int x = 0; x < bw4; ++x) {
        if (c + x >= mi_cols) break;
        int64_t k = (int64_t)(r + y) * mi_cols + c + x;
        y_modes[k] = (uint8_t)y_mode; uv_modes[k] = (uint8_t)uv_mode; mi_sizes[k] = (uint8_t)bsize;
        skips[k] = (uint8_t)skip;
      }
    }
    residual();
  }

  void intra_frame_mode_info() {
    int ctx = (avail_u ? skips[(mi_row - 1) * mi_cols + mi_col] : 0) +
              (avail_l ? skips[mi_row * mi_cols + mi_col - 1] : 0);
    skip = sym.read(cdf.skip[ctx], 2);
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
      bool cfl_allowed = mi_size == B4X4;  // lossless: the chroma residual block is 4x4 (4:4:4)
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
    use_filter_intra = 0;
    if (seq.filter_intra && y_mode == DC_PRED && std::max(kWide4[mi_size], kHigh4[mi_size]) <= 8) {
      use_filter_intra = sym.read(cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) filter_intra_mode = sym.read(cdf.filter_intra_mode, 5);
    }
  }

  // ---- residual and reconstruction (5.11.34, 7.11, 7.13) ----
  void residual() {
    int sb_mask = seq.sb128 ? 31 : 15;
    int wc = std::max(1, kWide4[mi_size] >> 4), hc = std::max(1, kHigh4[mi_size] >> 4);
    for (int cy = 0; cy < hc; ++cy) {
      for (int cx = 0; cx < wc; ++cx) {
        for (int plane = 0; plane < 1 + 2 * has_chroma; ++plane) {
          int n4w = kWide4[mi_size], n4h = kHigh4[mi_size];
          for (int y = 0; y < std::min(n4h, 16); ++y)
            for (int x = 0; x < std::min(n4w, 16); ++x)
              transform_block(plane, mi_col * 4, mi_row * 4, x + (cx << 4), y + (cy << 4), sb_mask);
        }
      }
    }
  }

  void transform_block(int plane, int base_x, int base_y, int x, int y, int sb_mask) {
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int row = start_y >> 2, col = start_x >> 2;
    int sub_row = row & sb_mask, sub_col = col & sb_mask;
    int max_x = mi_cols * 4 - 1, max_y = mi_rows * 4 - 1;
    if (start_x >= max_x + 1 || start_y >= max_y + 1) return;
    int mode = plane == 0 ? y_mode : (uv_mode == UV_CFL_PRED ? DC_PRED : uv_mode);
    predict_intra(plane, start_x, start_y, avail_l || x > 0, avail_u || y > 0,
                  block_decoded(plane, sub_row - 1, sub_col + 1), block_decoded(plane, sub_row + 1, sub_col - 1),
                  mode);
    if (plane > 0 && uv_mode == UV_CFL_PRED) predict_cfl(plane, start_x, start_y);
    if (!skip) {
      int32_t coef[16];
      if (coeffs(plane, row, col, coef)) reconstruct(plane, start_x, start_y, coef);
    }
    block_decoded(plane, sub_row, sub_col) = 1;
  }

  int is_smooth(int r, int c, int plane) const {
    int m = plane == 0 ? y_modes[r * mi_cols + c] : uv_modes[r * mi_cols + c];
    return m == SMOOTH_PRED || m == SMOOTH_V_PRED || m == SMOOTH_H_PRED;
  }

  // 7.11.2: a 4x4 prediction at (x, y) of ``plane``
  void predict_intra(int plane, int x, int y, int have_left, int have_above, int have_above_rt,
                     int have_below_lft, int mode) {
    const int w = 4, h = 4, bd = seq.bit_depth;
    int max_x = mi_cols * 4 - 1, max_y = mi_rows * 4 - 1;
    int above_buf[2 * 16 + 32], left_buf[2 * 16 + 32];
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
    int pred[4][4];
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
          // filter_corner: only for w + h >= 24
          int filter_type = 0;
          if (avail_u) filter_type |= is_smooth(mi_row - 1, mi_col, plane);
          if (avail_l) filter_type |= is_smooth(mi_row, mi_col - 1, plane);
          if (have_above) {
            int strength = edge_strength(filter_type, p_angle - 90);
            int num = std::min(w, max_x - x + 1) + (p_angle < 90 ? h : 0) + 1;
            edge_filter(above, num, strength);
          }
          if (have_left) {
            int strength = edge_strength(filter_type, p_angle - 180);
            int num = std::min(h, max_y - y + 1) + (p_angle > 180 ? w : 0) + 1;
            edge_filter(left, num, strength);
          }
          up_above = use_upsample(p_angle - 90);
          if (up_above) edge_upsample(above, w + (p_angle < 90 ? h : 0), bd);
          up_left = use_upsample(p_angle - 180);
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
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j) {
          int s = kSmWeights4[i] * above[j] + (256 - kSmWeights4[i]) * left[h - 1] + kSmWeights4[j] * left[i] +
                  (256 - kSmWeights4[j]) * above[w - 1];
          pred[i][j] = (s + 256) >> 9;
        }
    } else if (mode == SMOOTH_V_PRED) {
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j)
          pred[i][j] = (kSmWeights4[i] * above[j] + (256 - kSmWeights4[i]) * left[h - 1] + 128) >> 8;
    } else if (mode == SMOOTH_H_PRED) {
      for (int i = 0; i < h; ++i)
        for (int j = 0; j < w; ++j)
          pred[i][j] = (kSmWeights4[j] * left[i] + (256 - kSmWeights4[j]) * above[w - 1] + 128) >> 8;
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
        avg = (sum + (h >> 1)) >> 2;
      } else if (have_above) {
        int sum = 0;
        for (int k = 0; k < w; ++k) sum += above[k];
        avg = (sum + (w >> 1)) >> 2;
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

  // 7.11.2.9 (a 4x4 block: w + h is 8)
  static int edge_strength(int filter_type, int delta) {
    int d = std::abs(delta);
    if (filter_type == 0) return d >= 56 ? 1 : 0;
    return d >= 64 ? 2 : d >= 40 ? 1 : 0;
  }

  // 7.11.2.10 at w + h = 8, which passes both limits (8 with smooth neighbours, else 16)
  static int use_upsample(int delta) {
    int d = std::abs(delta);
    return d > 0 && d < 40;
  }

  // 7.11.2.12: the edge filter over edge[-1 .. sz - 2]
  static void edge_filter(int* edge, int sz, int strength) {
    if (!strength) return;
    int e[40];
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

  // 7.11.5: chroma from luma on a 4x4 block of 4:4:4
  void predict_cfl(int plane, int x, int y) {
    int alpha = plane == 1 ? cfl_alpha_u : cfl_alpha_v;
    int l[4][4], sum = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        l[i][j] = px(0, y + i, x + j) << 3;
        sum += l[i][j];
      }
    int avg = (sum + 8) >> 4;
    const int maxv = (1 << seq.bit_depth) - 1;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) {
        int scaled = alpha * (l[i][j] - avg);
        scaled = scaled >= 0 ? (scaled + 32) >> 6 : -((-scaled + 32) >> 6);
        int v = px(plane, y + i, x + j) + scaled;
        px(plane, y + i, x + j) = (uint16_t)(v < 0 ? 0 : v > maxv ? maxv : v);
      }
  }

  // 5.11.39: a TX_4X4 block's coefficients -> whether any is non-zero (eob > 0)
  bool coeffs(int plane, int y4, int x4, int32_t* out) {
    const int ptype = plane > 0;
    int ctx;
    if (plane == 0) {
      if (mi_size == B4X4) {
        ctx = 0;
      } else {
        int top = std::min<int>(above_level[0][x4], 255), left = std::min<int>(left_level[0][y4], 255);
        if (!top && !left) ctx = 1;
        else if (!top || !left) ctx = 2 + (std::max(top, left) > 3);
        else if (std::max(top, left) <= 3) ctx = 4;
        else if (std::min(top, left) <= 3) ctx = 5;
        else ctx = 6;
      }
    } else {
      int above = above_level[plane][x4] | above_dc[plane][x4];
      int left = left_level[plane][y4] | left_dc[plane][y4];
      ctx = 7 + (above != 0) + (left != 0) + (mi_size != B4X4 ? 3 : 0);
    }
    int all_zero = sym.read(cdf.txb_skip[ctx], 2);
    int cul_level = 0, dc_category = 0;
    for (int c = 0; c < 16; ++c) out[c] = 0;
    int32_t quant[16] = {0};
    int eob = 0;
    if (!all_zero) {
      int eob_pt = sym.read(cdf.eob16[ptype][0], 5) + 1;
      eob = eob_pt < 2 ? eob_pt : (1 << (eob_pt - 2)) + 1;
      int shift = eob_pt - 3;
      if (shift >= 0) {
        if (sym.read(cdf.eob_extra[ptype][eob_pt - 3], 2)) eob += 1 << shift;
        for (int i = 1; i < std::max(1, eob_pt - 2); ++i) {
          if (sym.boolean()) eob += 1 << (eob_pt - 3 - i);
        }
      }
      for (int c = eob - 1; c >= 0; --c) {
        int pos = kDefaultScan4x4[c];
        int level;
        if (c == eob - 1) {
          int bctx = c == 0 ? 0 : c <= 2 ? 1 : c <= 4 ? 2 : 3;
          level = sym.read(cdf.base_eob[ptype][bctx], 3) + 1;
        } else {
          level = sym.read(cdf.base[ptype][base_ctx(quant, pos)], 4);
        }
        if (level > 2) {
          int bctx = br_ctx(quant, pos);
          for (int k = 0; k < 4; ++k) {
            int br = sym.read(cdf.br[ptype][bctx], 4);
            level += br;
            if (br < 3) break;
          }
        }
        quant[pos] = level;
      }
      for (int c = 0; c < eob; ++c) {
        int pos = kDefaultScan4x4[c];
        int sign = 0;
        if (quant[pos] != 0) {
          if (c == 0) {
            int dctx = 0, s = 0;
            if (above_dc[plane][x4] == 1) --s; else if (above_dc[plane][x4] == 2) ++s;
            if (left_dc[plane][y4] == 1) --s; else if (left_dc[plane][y4] == 2) ++s;
            dctx = s < 0 ? 1 : s > 0 ? 2 : 0;
            sign = sym.read(cdf.dc_sign[ptype][dctx], 2);
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
        cul_level = (int)std::min<int64_t>(63, cul_level + level);
        // dequantisation at q index 0 (both quantizers 4), as libaom masks it: (level * 4) & 0xFFFFFF
        int64_t dq = (level * 4) & 0xFFFFFF;
        const int64_t lim = 1ll << (7 + seq.bit_depth);
        dq = sign ? -dq : dq;
        out[pos] = (int32_t)std::min(std::max(dq, -lim), lim - 1);
        quant[pos] = (int32_t)std::min<int64_t>(level, 1 << 30);
      }
    }
    above_level[plane][x4] = (uint8_t)cul_level;
    above_dc[plane][x4] = (uint8_t)dc_category;
    left_level[plane][y4] = (uint8_t)cul_level;
    left_dc[plane][y4] = (uint8_t)dc_category;
    return eob > 0;
  }

  static int base_ctx(const int32_t* q, int pos) {
    int row = pos >> 2, col = pos & 3;
    static const int off[5][2] = {{0, 1}, {1, 0}, {1, 1}, {0, 2}, {2, 0}};
    int mag = 0;
    for (int k = 0; k < 5; ++k) {
      int r = row + off[k][0], c = col + off[k][1];
      if (r < 4 && c < 4) mag += std::min(std::abs(q[r * 4 + c]), 3);
    }
    int ctx = std::min((mag + 1) >> 1, 4);
    if (row == 0 && col == 0) return 0;
    return ctx + kCoeffBaseCtxOffset4x4[std::min(row, 4)][std::min(col, 4)];
  }

  static int br_ctx(const int32_t* q, int pos) {
    int row = pos >> 2, col = pos & 3;
    static const int off[3][2] = {{0, 1}, {1, 0}, {1, 1}};
    int mag = 0;
    for (int k = 0; k < 3; ++k) {
      int r = row + off[k][0], c = col + off[k][1];
      if (r < 4 && c < 4) mag += std::min(q[r * 4 + c], 15);
    }
    mag = std::min((mag + 1) >> 1, 6);
    if (pos == 0) return mag;
    if (row < 2 && col < 2) return mag + 7;
    return mag + 14;
  }

  // 7.13.2.10 and 7.13.3: the inverse Walsh-Hadamard transform (rows with shift 2, then columns), added
  void reconstruct(int plane, int x, int y, const int32_t* coef) {
    int64_t t[4][4];
    for (int i = 0; i < 4; ++i) {
      int64_t a = coef[i * 4 + 0] >> 2, c = coef[i * 4 + 1] >> 2, d = coef[i * 4 + 2] >> 2, b = coef[i * 4 + 3] >> 2;
      a += c; d -= b;
      int64_t e = (a - d) >> 1;
      b = e - b; c = e - c;
      a -= b; d += c;
      t[i][0] = a; t[i][1] = b; t[i][2] = c; t[i][3] = d;
    }
    const int maxv = (1 << seq.bit_depth) - 1;
    for (int j = 0; j < 4; ++j) {
      int64_t a = t[0][j], c = t[1][j], d = t[2][j], b = t[3][j];
      a += c; d -= b;
      int64_t e = (a - d) >> 1;
      b = e - b; c = e - c;
      a -= b; d += c;
      int64_t r[4] = {a, b, c, d};
      for (int i = 0; i < 4; ++i) {
        int64_t v = px(plane, y + i, x + j) + r[i];
        px(plane, y + i, x + j) = (uint16_t)(v < 0 ? 0 : v > maxv ? maxv : v);
      }
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
// transfer characteristics, subsampling x, subsampling y.
int av1_decode(const uint8_t* src, int64_t n, int32_t* meta) {
  delete g_last;
  for (int i = 0; i < 11; ++i) meta[i] = 0;
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
  return 0;
}

// The planes of the last av1_decode of this thread (Y, then U and V, each
// height rows of width samples) into out; -1 if out is too small.
int av1_planes(uint16_t* out, int64_t cap) {
  if (!g_last) return -1;
  Decoder& d = *g_last;
  if (cap < (int64_t)d.planes * d.width * d.height) return -1;
  for (int p = 0; p < d.planes; ++p)
    for (int y = 0; y < d.height; ++y)
      std::memcpy(out + ((int64_t)p * d.height + y) * d.width, &d.frame[p][(int64_t)y * d.stride],
                  sizeof(uint16_t) * d.width);
  delete g_last;
  g_last = nullptr;
  return 0;
}

}  // extern "C"
