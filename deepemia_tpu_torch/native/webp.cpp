// WebP decoders of read_image (C ABI, ctypes-loaded by
// deepemia_tpu_torch/native/__init__.py): VP8L, the lossless bitstream
// (prefix codes, colour cache, backward references and the four
// transforms), and VP8 key frames, the lossy one (boolean decoder,
// segments, token partitions, intra prediction, WHT and integer IDCT, the
// simple and normal loop filters, then YUV 4:2:0 to BGR with libwebp's
// "fancy" upsampling), each step as libwebp 1.6 (OpenCV 5.0's) takes it, so
// that the pixels are cv2.imread's bit for bit. The RIFF container is read in
// ops/containers.py, which hands over the VP8 or VP8L chunk's payload.
//
// Built on first use: g++ -O2 -shared -fPIC webp.cpp -o
// build/torch_native/libwebp-<hash>.so
//
// Both entry points write [height][width][3] B, G, R into `out` and return
// 0, or a negative status: -1 a corrupt or truncated bitstream, -2 a form
// libwebp refuses too (a VP8 inter frame, an invisible frame).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// the quantizer steps of RFC 6386 section 14.1 (dc_qlookup, ac_qlookup)
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

// RFC 6386 section 13.5: the default token probabilities [type][band][context][node]
const uint8_t kCoeffsProba0[4][8][3][11] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
};

// RFC 6386 section 13.4: the probabilities that each token probability is updated
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
};

// RFC 6386 section 11.5: the key-frame subblock mode probabilities [above][left][node]
const uint8_t kBModesProba[10][10][9] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,
};

// the VP8L distance map (WebP lossless bitstream, section 4.2.2): 16 * dy + 8 - dx
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57,
    21, 27, 54, 58, 37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74,
    36, 44, 88, 69, 75, 52, 60, 3, 87, 89, 19, 29, 86, 90, 35, 45,
    68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30, 102, 106, 34, 46,
    84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94,
    0, 116, 124, 65, 79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114,
    126, 97, 111, 80, 113, 127, 96, 112,
};

// ---------------------------------------------------------------------------
// VP8L
// ---------------------------------------------------------------------------

struct LBits {  // LSB-first bits; reading past the end yields zeros and sets eos
  const uint8_t* p;
  int64_t n, pos = 0, used = 0;
  uint64_t val = 0;
  int nbits = 0;
  bool eos = false;
  LBits(const uint8_t* d, int64_t len) : p(d), n(len) {}
  void fill() {
    while (nbits <= 56) {
      const uint64_t b = pos < n ? p[pos] : 0;
      val |= b << nbits;
      nbits += 8;
      ++pos;
    }
  }
  uint32_t peek(int k) { fill(); return (uint32_t)(val & ((1ull << k) - 1)); }
  void skip(int k) {
    val >>= k;
    nbits -= k;
    used += k;
    if (used > 8 * n) eos = true;
  }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    skip(k);
    return v;
  }
};

const int kMaxCodeLength = 15;

struct Huffman {  // canonical prefix code, read first bit first (the code's top bit)
  bool single = false;
  int single_symbol = 0;
  int count[kMaxCodeLength + 1] = {0};
  std::vector<int> symbols;   // by (length, symbol)
  std::vector<uint32_t> fast; // 8 bits of lookahead -> symbol | length << 16, 0 where longer

  // VP8LBuildHuffmanTable's checks: lengths up to 15, not all zero, a
  // single used symbol read with no bits, else a complete code
  bool build(const int* lengths, int size) {
    for (int s = 0; s < size; ++s) {
      if (lengths[s] > kMaxCodeLength) return false;
      ++count[lengths[s]];
    }
    if (count[0] == size) return false;
    int used = size - count[0];
    if (used == 1) {
      for (int s = 0; s < size; ++s)
        if (lengths[s]) single_symbol = s;
      single = true;
      return true;
    }
    int64_t left = 1;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      left <<= 1;
      left -= count[len];
      if (left < 0) return false;
    }
    if (left != 0) return false;
    int offs[kMaxCodeLength + 2] = {0};
    for (int len = 1; len <= kMaxCodeLength; ++len) offs[len + 1] = offs[len] + count[len];
    symbols.assign(used, 0);
    for (int s = 0; s < size; ++s)
      if (lengths[s]) symbols[offs[lengths[s]]++] = s;
    fast.assign(256, 0);
    int code = 0, k = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      for (int i = 0; i < count[len]; ++i, ++k, ++code) {
        if (len > 8) continue;
        int rev = 0;
        for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
        for (int j = rev; j < 256; j += 1 << len) fast[j] = (uint32_t)symbols[k] | ((uint32_t)len << 16);
      }
      code <<= 1;
    }
    return true;
  }
  int read(LBits& br) const {
    if (single) return single_symbol;
    const uint32_t f = fast[br.peek(8)];
    if (f) {
      br.skip((int)(f >> 16));
      return (int)(f & 0xffff);
    }
    int code = 0, first = 0, index = 0;
    for (int len = 1; len <= kMaxCodeLength; ++len) {
      code |= (int)br.read(1);
      const int c = count[len];
      if (code - first < c) return symbols[index + code - first];
      index += c;
      first = (first + c) << 1;
      code <<= 1;
    }
    return 0;  // not reached for a complete code
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};
const int kAlphabet[5] = {256 + 24, 256, 256, 256, 40};

bool read_code(LBits& br, int alphabet, Huffman& out) {
  std::vector<int> lengths(alphabet, 0);
  if (br.read(1)) {  // simple code: one or two symbols
    const int num = (int)br.read(1) + 1;
    const int first_bits = br.read(1) ? 8 : 1;
    const int s0 = (int)br.read(first_bits);
    if (s0 < alphabet) lengths[s0] = 1;
    if (num == 2) {
      const int s1 = (int)br.read(8);
      if (s1 < alphabet) lengths[s1] = 1;
    }
  } else {
    int cl[19] = {0};
    const int num = (int)br.read(4) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = (int)br.read(3);
    Huffman lens;
    if (!lens.build(cl, 19)) return false;
    int max_symbol = alphabet;
    if (br.read(1)) {
      const int nbits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(nbits);
      if (max_symbol > alphabet) return false;
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = lens.read(br);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        const int extra[3] = {2, 3, 7}, offset[3] = {3, 3, 11};
        int repeat = (int)br.read(extra[len - 16]) + offset[len - 16];
        if (symbol + repeat > alphabet) return false;
        const int v = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = v;
      }
    }
  }
  if (br.eos) return false;
  return out.build(lengths.data(), alphabet);
}

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct LDecoder {
  LBits br;
  std::vector<Transform> transforms;
  unsigned seen = 0;
  explicit LDecoder(const uint8_t* d, int64_t n) : br(d, n) {}

  bool decode_stream(int xsize, int ysize, bool level0, std::vector<uint32_t>& out, int* final_xsize) {
    int txsize = xsize;
    if (level0) {
      while (br.read(1)) {
        if (!read_transform(&txsize, ysize)) return false;
      }
    }
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > 11) return false;
    }
    // prefix codes, one group or a meta image of groups
    int huff_bits = 0, groups = 1;
    std::vector<uint32_t> meta;
    if (level0 && br.read(1)) {
      huff_bits = 2 + (int)br.read(3);
      const int hx = subsample(txsize, huff_bits), hy = subsample(ysize, huff_bits);
      if (!decode_stream(hx, hy, false, meta, nullptr)) return false;
      for (auto& m : meta) {
        m = (m >> 8) & 0xffff;
        groups = std::max(groups, (int)m + 1);
      }
    }
    if (br.eos) return false;
    std::vector<Huffman> codes((size_t)groups * 5);
    for (int g = 0; g < groups; ++g)
      for (int j = 0; j < 5; ++j) {
        const int alphabet = kAlphabet[j] + (j == 0 && cache_bits ? 1 << cache_bits : 0);
        if (!read_code(br, alphabet, codes[(size_t)g * 5 + j])) return false;
      }
    out.assign((size_t)txsize * ysize, 0);
    if (!decode_pixels(out, txsize, ysize, codes, meta, huff_bits, cache_bits)) return false;
    if (br.eos) return false;
    if (final_xsize) *final_xsize = txsize;
    return true;
  }

  bool read_transform(int* xsize, int ysize) {
    const int type = (int)br.read(2);
    if (seen & (1u << type)) return false;
    seen |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = *xsize;
    t.ysize = ysize;
    t.bits = 0;
    if (type == 0 || type == 1) {  // predictor, cross colour
      t.bits = 2 + (int)br.read(3);
      if (!decode_stream(subsample(t.xsize, t.bits), subsample(ysize, t.bits), false, t.data, nullptr)) return false;
    } else if (type == 3) {  // colour indexing
      const int num = (int)br.read(8) + 1;
      t.bits = num > 16 ? 0 : num > 4 ? 1 : num > 2 ? 2 : 3;
      *xsize = subsample(t.xsize, t.bits);
      std::vector<uint32_t> pal;
      if (!decode_stream(num, 1, false, pal, nullptr)) return false;
      const int final_num = 1 << (8 >> t.bits);
      t.data.assign(final_num, 0);
      t.data[0] = pal[0];
      for (int i = 1; i < num; ++i) {  // delta-coded, byte by byte
        uint32_t v = 0;
        for (int c = 0; c < 32; c += 8)
          v |= ((((pal[i] >> c) & 0xff) + ((t.data[i - 1] >> c) & 0xff)) & 0xff) << c;
        t.data[i] = v;
      }
    }
    transforms.push_back(std::move(t));
    return true;
  }

  bool decode_pixels(std::vector<uint32_t>& px, int width, int height, const std::vector<Huffman>& codes,
                     const std::vector<uint32_t>& meta, int huff_bits, int cache_bits) {
    const int64_t total = (int64_t)width * height;
    std::vector<uint32_t> cache(cache_bits ? (size_t)1 << cache_bits : 0, 0);
    const int mw = huff_bits ? subsample(width, huff_bits) : 0;
    int64_t i = 0, cached = 0;
    auto insert = [&](int64_t upto) {
      for (; cached < upto; ++cached)
        cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    while (i < total) {
      const int x = (int)(i % width), y = (int)(i / width);
      const size_t group = huff_bits ? meta[(size_t)(y >> huff_bits) * mw + (x >> huff_bits)] : 0;
      const Huffman* g = codes.data() + group * 5;
      const int code = g[0].read(br);
      if (br.eos) return false;
      if (code < 256) {
        const int red = g[1].read(br), blue = g[2].read(br), alpha = g[3].read(br);
        if (br.eos) return false;
        px[i++] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) | (uint32_t)blue;
      } else if (code < 256 + 24) {
        const int length = copy_value(code - 256);
        const int dist_symbol = g[4].read(br);
        const int dist_code = copy_value(dist_symbol);
        int64_t dist;
        if (dist_code > 120) {
          dist = dist_code - 120;
        } else {
          const int c = kCodeToPlane[dist_code - 1];
          dist = (int64_t)(c >> 4) * width + 8 - (c & 15);
          if (dist < 1) dist = 1;
        }
        if (br.eos) return false;
        if (i < dist || total - i < length) return false;
        for (int k = 0; k < length; ++k, ++i) px[i] = px[i - dist];
      } else {
        if (!cache_bits) return false;
        insert(i);
        px[i] = cache[code - 256 - 24];
        ++i;
      }
      if (cache_bits) insert(i);
    }
    return true;
  }

  int copy_value(int symbol) {
    if (symbol < 4) return symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const int offset = (2 + (symbol & 1)) << extra;
    return offset + (int)br.read(extra) + 1;
  }
};

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline int ch(uint32_t v, int c) { return (int)((v >> c) & 0xff); }

uint32_t select_pred(uint32_t top, uint32_t left, uint32_t tl) {
  int s = 0;
  for (int c = 0; c < 32; c += 8) {
    const int pb = ch(left, c) - ch(tl, c), pa = ch(top, c) - ch(tl, c);
    s += std::abs(pb) - std::abs(pa);
  }
  return s <= 0 ? top : left;
}

uint32_t predict(int mode, uint32_t left, uint32_t top, uint32_t tr, uint32_t tl) {
  switch (mode) {
    case 1: return left;
    case 2: return top;
    case 3: return tr;
    case 4: return tl;
    case 5: return average2(average2(left, tr), top);
    case 6: return average2(left, tl);
    case 7: return average2(left, top);
    case 8: return average2(tl, top);
    case 9: return average2(top, tr);
    case 10: return average2(average2(left, tl), average2(top, tr));
    case 11: return select_pred(top, left, tl);
    case 12: {
      uint32_t v = 0;
      for (int c = 0; c < 32; c += 8) v |= (uint32_t)clip255(ch(left, c) + ch(top, c) - ch(tl, c)) << c;
      return v;
    }
    case 13: {
      const uint32_t a = average2(left, top);
      uint32_t v = 0;
      for (int c = 0; c < 32; c += 8) {
        const int x = ch(a, c);
        v |= (uint32_t)clip255(x + (x - ch(tl, c)) / 2) << c;
      }
      return v;
    }
    default: return 0xff000000u;  // 0, and the padding modes 14 and 15
  }
}

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline int color_delta(int8_t pred, int8_t color) { return ((int)pred * color) >> 5; }

// the inverse transforms, last read first; px is the image at t's input width
void inverse_transform(const Transform& t, std::vector<uint32_t>& px) {
  const int w = t.xsize, h = t.ysize;
  if (t.type == 2) {  // subtract green
    for (auto& v : px) {
      const uint32_t g = (v >> 8) & 0xff;
      const uint32_t rb = ((v & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
      v = (v & 0xff00ff00u) | rb;
    }
  } else if (t.type == 1) {  // cross colour
    const int bw = subsample(w, t.bits);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t m = t.data[(size_t)(y >> t.bits) * bw + (x >> t.bits)];
        const int8_t g2r = (int8_t)(m & 0xff), g2b = (int8_t)((m >> 8) & 0xff), r2b = (int8_t)((m >> 16) & 0xff);
        uint32_t& v = px[(size_t)y * w + x];
        const int8_t green = (int8_t)(v >> 8);
        int red = (int)((v >> 16) & 0xff), blue = (int)(v & 0xff);
        red = (red + color_delta(g2r, green)) & 0xff;
        blue = (blue + color_delta(g2b, green) + color_delta(r2b, (int8_t)red)) & 0xff;
        v = (v & 0xff00ff00u) | ((uint32_t)red << 16) | (uint32_t)blue;
      }
  } else if (t.type == 0) {  // predictor
    const int bw = subsample(w, t.bits);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const size_t i = (size_t)y * w + x;
        int mode;
        if (y == 0) mode = x == 0 ? 0 : 1;
        else if (x == 0) mode = 2;
        else mode = (int)((t.data[(size_t)(y >> t.bits) * bw + (x >> t.bits)] >> 8) & 0xf);
        const uint32_t left = x ? px[i - 1] : 0, top = y ? px[i - w] : 0;
        // the top-right of the last column is this row's first pixel
        const uint32_t tl = x && y ? px[i - w - 1] : 0, tr = y ? px[i - w + 1] : 0;
        px[i] = add_pixels(px[i], predict(mode, left, top, tr, tl));
      }
  } else {  // colour indexing: the output is wider than the input where indices are packed
    std::vector<uint32_t> out((size_t)w * h);
    const int bits = t.bits;
    const int in_w = subsample(w, bits);
    const int per = 1 << bits, bpp = 8 >> bits;
    const uint32_t mask = (1u << bpp) - 1;
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t packed = (px[(size_t)y * in_w + (x >> bits)] >> 8) & 0xff;
        const uint32_t index = bits ? (packed >> ((x & (per - 1)) * bpp)) & mask : packed;
        out[(size_t)y * w + x] = t.data[index];
      }
    px.swap(out);
  }
}

// ---------------------------------------------------------------------------
// VP8 key frames
// ---------------------------------------------------------------------------

struct BoolDecoder {  // libwebp's VP8BitReader: range kept as range - 1
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;
  uint32_t range = 254;
  bool eof = false;
  void init(const uint8_t* start, int64_t size) {
    buf = start;
    end = start + size;
    value = 0;
    bits = -8;
    range = 254;
    eof = false;
    load();
  }
  void load() {
    if (buf < end) {
      bits += 8;
      value = (value << 8) | *buf++;
    } else if (!eof) {
      value <<= 8;
      bits += 8;
      eof = true;
    } else {
      bits = 0;
    }
  }
  int get_bit(int prob) {
    uint32_t r = range;
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = (r * (uint32_t)prob) >> 8;
    const uint32_t v = (uint32_t)(value >> pos);
    int bit;
    if (v > split) {
      r -= split;
      value -= (uint64_t)(split + 1) << pos;
      bit = 1;
    } else {
      r = split + 1;
      bit = 0;
    }
    int shift = 7;
    for (uint32_t t = r; t > 1; t >>= 1) --shift;  // 7 ^ floor(log2(r))
    r <<= shift;
    bits -= shift;
    range = r - 1;
    return bit;
  }
  int get_signed(int v) {  // VP8GetSigned: probability 1/2, always one bit of shift
    if (bits < 0) load();
    const int pos = bits;
    const uint32_t split = range >> 1;
    const uint32_t val = (uint32_t)(value >> pos);
    const int32_t mask = (int32_t)(split - val) >> 31;
    bits -= 1;
    range += (uint32_t)mask;
    range |= 1;
    value -= (uint64_t)((split + 1) & (uint32_t)mask) << pos;
    return (v ^ mask) - mask;
  }
  uint32_t get_value(int n) {
    uint32_t v = 0;
    while (n-- > 0) v |= (uint32_t)get_bit(0x80) << n;
    return v;
  }
  int get_signed_value(int n) {
    const int v = (int)get_value(n);
    return get_value(1) ? -v : v;
  }
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

const int BPS = 32;

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void transform_one(const int16_t* in, uint8_t* dst) {  // TransformOne_C
  int tmp[16];
  int* t = tmp;
  for (int i = 0; i < 4; ++i, ++in, t += 4) {
    const int a = in[0] + in[8], b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
    t[0] = a + d;
    t[1] = b + c;
    t[2] = b - c;
    t[3] = a - d;
  }
  t = tmp;
  for (int i = 0; i < 4; ++i, ++t, dst += BPS) {
    const int dc = t[0] + 4;
    const int a = dc + t[8], b = dc - t[8];
    const int c = mul2(t[4]) - mul1(t[12]), d = mul1(t[4]) + mul2(t[12]);
    dst[0] = clip8(dst[0] + ((a + d) >> 3));
    dst[1] = clip8(dst[1] + ((b + c) >> 3));
    dst[2] = clip8(dst[2] + ((b - c) >> 3));
    dst[3] = clip8(dst[3] + ((a - d) >> 3));
  }
}

void transform_wht(const int16_t* in, int16_t* out) {  // TransformWHT_C
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// intra predictors on a BPS-strided block whose top row, left column,
// top-left and (4x4) top-right samples are in place
void pred_tm(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y, dst += BPS)
    for (int x = 0; x < size; ++x) dst[x] = clip8(top[x] + dst[-1] - tl);
}
void fill(uint8_t* dst, int size, int v) {
  for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, v, size);
}
void pred_large(uint8_t* dst, int size, int mode) {  // 16x16 luma (size 16) and 8x8 chroma (size 8)
  const int shift = size == 16 ? 4 : 3;
  switch (mode) {
    case 0: {  // DC
      int dc = size;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, size, dc >> (shift + 1));
      break;
    }
    case 1: pred_tm(dst, size); break;
    case 2:
      for (int y = 0; y < size; ++y) std::memcpy(dst + y * BPS, dst - BPS, size);
      break;
    case 3:
      for (int y = 0; y < size; ++y) std::memset(dst + y * BPS, dst[y * BPS - 1], size);
      break;
    case 4: {  // DC without the top row: the left column
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[-1 + j * BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    case 5: {  // DC without the left column: the top row
      int dc = size >> 1;
      for (int j = 0; j < size; ++j) dc += dst[j - BPS];
      fill(dst, size, dc >> shift);
      break;
    }
    default: fill(dst, size, 0x80); break;
  }
}

#define DST(x, y) dst[(x) + (y) * BPS]
void pred4(uint8_t* dst, int mode) {
  const uint8_t* top = dst - BPS;
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  switch (mode) {
    case 0: {  // DC
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += dst[i - BPS] + dst[-1 + i * BPS];
      fill(dst, 4, dc >> 3);
      break;
    }
    case 1: pred_tm(dst, 4); break;
    case 2: {  // VE: the smoothed top row
      const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) std::memcpy(dst + i * BPS, v, 4);
      break;
    }
    case 3:  // HE: the smoothed left column
      std::memset(dst, avg3(X, I, J), 4);
      std::memset(dst + BPS, avg3(I, J, K), 4);
      std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
      std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case 4:  // RD
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case 5:  // VR
      DST(0, 0) = DST(1, 2) = avg2(X, A);
      DST(1, 0) = DST(2, 2) = avg2(A, B);
      DST(2, 0) = DST(3, 2) = avg2(B, C);
      DST(3, 0) = avg2(C, D);
      DST(0, 3) = avg3(K, J, I);
      DST(0, 2) = avg3(J, I, X);
      DST(0, 1) = DST(1, 3) = avg3(I, X, A);
      DST(1, 1) = DST(2, 3) = avg3(X, A, B);
      DST(2, 1) = DST(3, 3) = avg3(A, B, C);
      DST(3, 1) = avg3(B, C, D);
      break;
    case 6:  // LD
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case 7:  // VL
      DST(0, 0) = avg2(A, B);
      DST(1, 0) = DST(0, 2) = avg2(B, C);
      DST(2, 0) = DST(1, 2) = avg2(C, D);
      DST(3, 0) = DST(2, 2) = avg2(D, E);
      DST(0, 1) = avg3(A, B, C);
      DST(1, 1) = DST(0, 3) = avg3(B, C, D);
      DST(2, 1) = DST(1, 3) = avg3(C, D, E);
      DST(3, 1) = DST(2, 3) = avg3(D, E, F);
      DST(3, 2) = avg3(E, F, G);
      DST(3, 3) = avg3(F, G, H);
      break;
    case 8:  // HD
      DST(0, 0) = DST(2, 1) = avg2(I, X);
      DST(0, 1) = DST(2, 2) = avg2(J, I);
      DST(0, 2) = DST(2, 3) = avg2(K, J);
      DST(0, 3) = avg2(L, K);
      DST(3, 0) = avg3(A, B, C);
      DST(2, 0) = avg3(X, A, B);
      DST(1, 0) = DST(3, 1) = avg3(I, X, A);
      DST(1, 1) = DST(3, 2) = avg3(J, I, X);
      DST(1, 2) = DST(3, 3) = avg3(K, J, I);
      DST(1, 3) = avg3(L, K, J);
      break;
    default:  // HU
      DST(0, 0) = avg2(I, J);
      DST(2, 0) = DST(0, 1) = avg2(J, K);
      DST(2, 1) = DST(0, 2) = avg2(K, L);
      DST(1, 0) = avg3(I, J, K);
      DST(3, 0) = DST(1, 1) = avg3(J, K, L);
      DST(3, 1) = DST(1, 2) = avg3(K, L, L);
      DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = (uint8_t)L;
      break;
  }
}
#undef DST

// loop filters (dsp/dec.c), on a plane of stride `stride`
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }   // VP8ksclip1
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }       // VP8ksclip2

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}
inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}
inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}
inline bool hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}
inline bool needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}
inline bool needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}
void simple_filter(uint8_t* p, int hstride, int vstride, int thresh) {  // 16 pixels along vstride
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, t2)) do_filter2(p, hstride);
}
void filter_loop(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh, int hev_t, bool edge) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, t2, ithresh)) continue;
    if (hev(p, hstride, hev_t)) do_filter2(p, hstride);
    else if (edge) do_filter6(p, hstride);
    else do_filter4(p, hstride);
  }
}

// libwebp's YUV -> RGB (yuv.h, 14-bit fixed point)
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline int yuv_clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255; }
inline void yuv_to_bgr(int y, int u, int v, uint8_t* bgr) {
  bgr[2] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  bgr[1] = (uint8_t)yuv_clip8(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  bgr[0] = (uint8_t)yuv_clip8(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// one output row pair of the fancy upsampler (UPSAMPLE_FUNC): the chroma of
// rows top_u (above) and cur_u, weighted 9:3:3:1 between the two rows and
// the two columns nearest each pixel
void upsample_pair(const uint8_t* top_y, const uint8_t* bot_y, const uint8_t* top_u, const uint8_t* top_v,
                   const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst, uint8_t* bot_dst, int len) {
  const int last_pair = (len - 1) >> 1;
  auto load = [](int u, int v) { return (uint32_t)u | ((uint32_t)v << 16); };
  uint32_t tl_uv = load(top_u[0], top_v[0]), l_uv = load(cur_u[0], cur_v[0]);
  {
    const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
    yuv_to_bgr(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
  }
  if (bot_y) {
    const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
    yuv_to_bgr(bot_y[0], uv0 & 0xff, uv0 >> 16, bot_dst);
  }
  for (int x = 1; x <= last_pair; ++x) {
    const uint32_t t_uv = load(top_u[x], top_v[x]), uv = load(cur_u[x], cur_v[x]);
    const uint32_t avg = tl_uv + t_uv + l_uv + uv + 0x00080008u;
    const uint32_t diag_12 = (avg + 2 * (t_uv + l_uv)) >> 3;
    const uint32_t diag_03 = (avg + 2 * (tl_uv + uv)) >> 3;
    {
      const uint32_t uv0 = (diag_12 + tl_uv) >> 1, uv1 = (diag_03 + t_uv) >> 1;
      yuv_to_bgr(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * 3);
      yuv_to_bgr(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * 3);
    }
    if (bot_y) {
      const uint32_t uv0 = (diag_03 + l_uv) >> 1, uv1 = (diag_12 + uv) >> 1;
      yuv_to_bgr(bot_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bot_dst + (2 * x - 1) * 3);
      yuv_to_bgr(bot_y[2 * x], uv1 & 0xff, uv1 >> 16, bot_dst + (2 * x) * 3);
    }
    tl_uv = t_uv;
    l_uv = uv;
  }
  if (!(len & 1)) {
    {
      const uint32_t uv0 = (3 * tl_uv + l_uv + 0x00020002u) >> 2;
      yuv_to_bgr(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * 3);
    }
    if (bot_y) {
      const uint32_t uv0 = (3 * l_uv + tl_uv + 0x00020002u) >> 2;
      yuv_to_bgr(bot_y[len - 1], uv0 & 0xff, uv0 >> 16, bot_dst + (len - 1) * 3);
    }
  }
}

struct MBInfo {
  uint8_t nz = 0, nz_dc = 0;
};

struct MBData {
  int16_t coeffs[384];
  uint8_t imodes[16];
  uint8_t is_i4x4, uvmode, segment, skip;
  uint32_t non_zero_y, non_zero_uv;
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev_thresh = 0;
};

struct VP8 {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  BoolDecoder br;
  std::vector<BoolDecoder> parts;
  // segment header
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0}, filter_strength[4] = {0};
  int segment_probs[3] = {255, 255, 255};
  // filter header
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0, filter_type = 0;
  int ref_lf_delta[4] = {0}, mode_lf_delta[4] = {0};
  int dq[4][3][2];  // [segment][y1, y2, uv][dc, ac]
  uint8_t proba[4][8][3][11];
  int use_skip = 0, skip_p = 0;
  FInfo fstrengths[4][2];

  int parse(const uint8_t* data, int64_t size) {
    if (size < 10) return -1;
    const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
    const int key = !(bits & 1), profile = (bits >> 1) & 7, show = (bits >> 4) & 1;
    const uint32_t part_len = bits >> 5;
    if (profile > 3) return -1;
    if (!show || !key) return -2;
    if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a) return -1;
    width = ((data[7] << 8) | data[6]) & 0x3fff;
    height = ((data[9] << 8) | data[8]) & 0x3fff;
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    const uint8_t* buf = data + 10;
    int64_t left = size - 10;
    if ((int64_t)part_len > left) return -1;
    br.init(buf, part_len);
    buf += part_len;
    left -= part_len;
    br.get_value(1);  // colour space
    br.get_value(1);  // clamping type
    use_segment = (int)br.get_value(1);
    if (use_segment) {
      update_map = (int)br.get_value(1);
      if (br.get_value(1)) {
        absolute_delta = (int)br.get_value(1);
        for (int s = 0; s < 4; ++s) quantizer[s] = br.get_value(1) ? br.get_signed_value(7) : 0;
        for (int s = 0; s < 4; ++s) filter_strength[s] = br.get_value(1) ? br.get_signed_value(6) : 0;
      }
      if (update_map)
        for (int s = 0; s < 3; ++s) segment_probs[s] = br.get_value(1) ? (int)br.get_value(8) : 255;
    }
    if (br.eof) return -1;
    simple = (int)br.get_value(1);
    level = (int)br.get_value(6);
    sharpness = (int)br.get_value(3);
    use_lf_delta = (int)br.get_value(1);
    if (use_lf_delta && br.get_value(1)) {
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) ref_lf_delta[i] = br.get_signed_value(6);
      for (int i = 0; i < 4; ++i)
        if (br.get_value(1)) mode_lf_delta[i] = br.get_signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    if (br.eof) return -1;
    // token partitions
    const int last = (1 << br.get_value(2)) - 1;
    if (left < 3 * (int64_t)last) return -1;
    const uint8_t* sz = buf;
    const uint8_t* part = buf + 3 * last;
    int64_t size_left = left - 3 * last;
    parts.assign(last + 1, BoolDecoder());
    for (int p = 0; p < last; ++p, sz += 3) {
      int64_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
      if (psize > size_left) psize = size_left;
      parts[p].init(part, psize);
      part += psize;
      size_left -= psize;
    }
    parts[last].init(part, size_left);
    if (size_left <= 0) return -1;
    // quantizers
    const int base_q = (int)br.get_value(7);
    int dqs[5];
    // y1 dc, y2 dc, y2 ac, uv dc, uv ac
    for (int i = 0; i < 5; ++i) dqs[i] = br.get_value(1) ? br.get_signed_value(4) : 0;
    for (int s = 0; s < 4; ++s) {
      int q = use_segment ? quantizer[s] + (absolute_delta ? 0 : base_q) : base_q;
      auto c = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
      dq[s][0][0] = kDcTable[c(q + dqs[0], 127)];
      dq[s][0][1] = kAcTable[c(q, 127)];
      dq[s][1][0] = kDcTable[c(q + dqs[1], 127)] * 2;
      dq[s][1][1] = std::max(8, (kAcTable[c(q + dqs[2], 127)] * 101581) >> 16);
      dq[s][2][0] = kDcTable[c(q + dqs[3], 117)];
      dq[s][2][1] = kAcTable[c(q + dqs[4], 127)];
    }
    br.get_value(1);  // refresh entropy probabilities: a key frame keeps them anyway
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int p = 0; p < 11; ++p)
            proba[t][b][c][p] = br.get_bit(kCoeffsUpdateProba[t][b][c][p]) ? (uint8_t)br.get_value(8)
                                                                           : kCoeffsProba0[t][b][c][p];
    use_skip = (int)br.get_value(1);
    if (use_skip) skip_p = (int)br.get_value(8);
    // filter strengths by segment and by 4x4 (B_PRED) or 16x16 prediction
    for (int s = 0; s < 4; ++s) {
      int base = use_segment ? filter_strength[s] + (absolute_delta ? 0 : level) : level;
      for (int i4 = 0; i4 <= 1; ++i4) {
        FInfo& f = fstrengths[s][i4];
        int lv = base;
        if (use_lf_delta) {
          lv += ref_lf_delta[0];
          if (i4) lv += mode_lf_delta[0];
        }
        lv = lv < 0 ? 0 : lv > 63 ? 63 : lv;
        if (lv > 0) {
          int il = lv;
          if (sharpness > 0) {
            il >>= sharpness > 4 ? 2 : 1;
            if (il > 9 - sharpness) il = 9 - sharpness;
          }
          if (il < 1) il = 1;
          f.ilevel = il;
          f.limit = 2 * lv + il;
          f.hev_thresh = lv >= 40 ? 2 : lv >= 15 ? 1 : 0;
        } else {
          f.limit = 0;
        }
        f.inner = i4;
      }
    }
    return 0;
  }

  int get_large_value(BoolDecoder& tb, const uint8_t* p) {
    int v;
    if (!tb.get_bit(p[3])) {
      v = !tb.get_bit(p[4]) ? 2 : 3 + tb.get_bit(p[5]);
    } else if (!tb.get_bit(p[6])) {
      if (!tb.get_bit(p[7])) {
        v = 5 + tb.get_bit(159);
      } else {
        v = 7 + 2 * tb.get_bit(165);
        v += tb.get_bit(145);
      }
    } else {
      const int bit1 = tb.get_bit(p[8]);
      const int bit0 = tb.get_bit(p[9 + bit1]);
      const int cat = 2 * bit1 + bit0;
      v = 0;
      for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + tb.get_bit(*tab);
      v += 3 + (8 << cat);
    }
    return v;
  }

  // GetCoeffs: the tokens of one block from position n, dequantized into out
  // (zigzag order undone) -> the position after the last non-zero one
  int get_coeffs(BoolDecoder& tb, int type, int ctx, const int* dqm, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!tb.get_bit(p[0])) return n;
      while (!tb.get_bit(p[1])) {
        p = proba[type][kBands[++n]][0];
        if (n == 16) return 16;
      }
      int v;
      if (!tb.get_bit(p[2])) {
        v = 1;
        p = proba[type][kBands[n + 1]][1];
      } else {
        v = get_large_value(tb, p);
        p = proba[type][kBands[n + 1]][2];
      }
      out[kZigzag[n]] = (int16_t)(tb.get_signed(v) * dqm[n > 0]);
    }
    return 16;
  }

  static uint32_t nz_code_bits(uint32_t nz_coeffs, int nz, int dc_nz) {
    nz_coeffs <<= 2;
    nz_coeffs |= nz > 3 ? 3 : nz > 1 ? 2 : dc_nz;
    return nz_coeffs;
  }

  // ParseResiduals -> whether the macroblock has no non-zero coefficient
  int parse_residuals(BoolDecoder& tb, MBInfo& mb, MBInfo& left, MBData& block) {
    const int (*q)[2] = dq[block.segment];
    int16_t* dst = block.coeffs;
    std::memset(dst, 0, sizeof(block.coeffs));
    int first, ac_type;
    if (!block.is_i4x4) {
      int16_t dc[16] = {0};
      const int ctx = mb.nz_dc + left.nz_dc;
      const int nz = get_coeffs(tb, 1, ctx, q[1], 0, dc);
      mb.nz_dc = left.nz_dc = nz > 0;
      if (nz > 1) {
        transform_wht(dc, dst);
      } else {
        const int dc0 = (dc[0] + 3) >> 3;
        for (int i = 0; i < 256; i += 16) dst[i] = (int16_t)dc0;
      }
      first = 1;
      ac_type = 0;
    } else {
      first = 0;
      ac_type = 3;
    }
    uint32_t non_zero_y = 0, non_zero_uv = 0;
    uint8_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
      int l = lnz & 1;
      uint32_t nz_coeffs = 0;
      for (int x = 0; x < 4; ++x) {
        const int ctx = l + (tnz & 1);
        const int nz = get_coeffs(tb, ac_type, ctx, q[0], first, dst);
        l = nz > first;
        tnz = (uint8_t)((tnz >> 1) | (l << 7));
        nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
        dst += 16;
      }
      tnz >>= 4;
      lnz = (uint8_t)((lnz >> 1) | (l << 7));
      non_zero_y = (non_zero_y << 8) | nz_coeffs;
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int c = 0; c < 4; c += 2) {
      uint32_t nz_coeffs = 0;
      tnz = (uint8_t)(mb.nz >> (4 + c));
      lnz = (uint8_t)(left.nz >> (4 + c));
      for (int y = 0; y < 2; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 2; ++x) {
          const int ctx = l + (tnz & 1);
          const int nz = get_coeffs(tb, 2, ctx, q[2], 0, dst);
          l = nz > 0;
          tnz = (uint8_t)((tnz >> 1) | (l << 3));
          nz_coeffs = nz_code_bits(nz_coeffs, nz, dst[0] != 0);
          dst += 16;
        }
        tnz >>= 2;
        lnz = (uint8_t)((lnz >> 1) | (l << 5));
      }
      non_zero_uv |= nz_coeffs << (4 * c);
      out_t_nz |= (uint32_t)(tnz << 4) << c;
      out_l_nz |= (uint32_t)(lnz & 0xf0) << c;
    }
    mb.nz = (uint8_t)out_t_nz;
    left.nz = (uint8_t)out_l_nz;
    block.non_zero_y = non_zero_y;
    block.non_zero_uv = non_zero_uv;
    return !(non_zero_y | non_zero_uv);
  }

  void parse_intra_mode(MBData& block, uint8_t* top, uint8_t* left) {
    if (update_map)
      block.segment = !br.get_bit(segment_probs[0]) ? (uint8_t)br.get_bit(segment_probs[1])
                                                    : (uint8_t)(br.get_bit(segment_probs[2]) + 2);
    else
      block.segment = 0;
    block.skip = use_skip ? (uint8_t)br.get_bit(skip_p) : 0;
    block.is_i4x4 = !br.get_bit(145);
    if (!block.is_i4x4) {
      const int ymode = br.get_bit(156) ? (br.get_bit(128) ? 1 : 3) : (br.get_bit(163) ? 2 : 0);
      block.imodes[0] = (uint8_t)ymode;
      std::memset(top, ymode, 4);
      std::memset(left, ymode, 4);
    } else {
      uint8_t* modes = block.imodes;
      for (int y = 0; y < 4; ++y) {
        int ymode = left[y];
        for (int x = 0; x < 4; ++x) {
          const uint8_t* prob = kBModesProba[top[x]][ymode];
          ymode = !br.get_bit(prob[0]) ? 0
                : !br.get_bit(prob[1]) ? 1
                : !br.get_bit(prob[2]) ? 2
                : !br.get_bit(prob[3]) ? (!br.get_bit(prob[4]) ? 3 : (!br.get_bit(prob[5]) ? 4 : 5))
                : (!br.get_bit(prob[6]) ? 6 : (!br.get_bit(prob[7]) ? 7 : (!br.get_bit(prob[8]) ? 8 : 9)));
          top[x] = (uint8_t)ymode;
        }
        std::memcpy(modes, top, 4);
        modes += 4;
        left[y] = (uint8_t)ymode;
      }
    }
    block.uvmode = !br.get_bit(142) ? 0 : !br.get_bit(114) ? 2 : br.get_bit(183) ? 1 : 3;
  }

  static int check_mode(int mb_x, int mb_y, int mode) {
    if (mode == 0) return mb_x == 0 ? (mb_y == 0 ? 6 : 5) : (mb_y == 0 ? 4 : 0);
    return mode;
  }

  int decode(const uint8_t* data, int64_t size, uint8_t* out) {
    const int st = parse(data, size);
    if (st) return st;
    const int yw = mb_w * 16, uvw = mb_w * 8;
    std::vector<uint8_t> Y((size_t)yw * mb_h * 16), U((size_t)uvw * mb_h * 8), V((size_t)uvw * mb_h * 8);
    std::vector<MBInfo> info(mb_w + 1);  // [0] is the left neighbour
    std::vector<MBData> row(mb_w);
    std::vector<FInfo> finfo((size_t)mb_w * mb_h);
    std::vector<uint8_t> intra_t(4 * mb_w, 0), top_y(16 * mb_w), top_u(8 * mb_w), top_v(8 * mb_w);
    uint8_t intra_l[4];
    uint8_t work[BPS * 17 + BPS * 9];
    uint8_t* const ydst = work + BPS + 8;
    uint8_t* const udst = ydst + BPS * 16 + BPS;
    uint8_t* const vdst = udst + 16;
    for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
      std::memset(intra_l, 0, 4);
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) parse_intra_mode(row[mb_x], &intra_t[4 * mb_x], intra_l);
      if (br.eof) return -1;
      BoolDecoder& tb = parts[mb_y & (parts.size() - 1)];
      info[0] = MBInfo();
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        MBData& block = row[mb_x];
        MBInfo& mb = info[mb_x + 1];
        int skip = block.skip;
        if (!skip) {
          skip = parse_residuals(tb, mb, info[0], block);
        } else {
          info[0].nz = mb.nz = 0;
          if (!block.is_i4x4) info[0].nz_dc = mb.nz_dc = 0;
          block.non_zero_y = block.non_zero_uv = 0;
        }
        if (filter_type > 0) {
          FInfo f = fstrengths[block.segment][block.is_i4x4];
          f.inner |= !skip;
          finfo[(size_t)mb_y * mb_w + mb_x] = f;
        }
        if (tb.eof) return -1;
      }
      // reconstruct the row (ReconstructRow), predicting from unfiltered samples
      for (int j = 0; j < 16; ++j) ydst[j * BPS - 1] = 129;
      for (int j = 0; j < 8; ++j) udst[j * BPS - 1] = vdst[j * BPS - 1] = 129;
      if (mb_y > 0) {
        ydst[-1 - BPS] = udst[-1 - BPS] = vdst[-1 - BPS] = 129;
      } else {
        std::memset(ydst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(udst - BPS - 1, 127, 8 + 1);
        std::memset(vdst - BPS - 1, 127, 8 + 1);
      }
      for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
        const MBData& block = row[mb_x];
        if (mb_x > 0) {
          for (int j = -1; j < 16; ++j) std::memcpy(ydst + j * BPS - 4, ydst + j * BPS + 12, 4);
          for (int j = -1; j < 8; ++j) {
            std::memcpy(udst + j * BPS - 4, udst + j * BPS + 4, 4);
            std::memcpy(vdst + j * BPS - 4, vdst + j * BPS + 4, 4);
          }
        }
        if (mb_y > 0) {
          std::memcpy(ydst - BPS, &top_y[16 * mb_x], 16);
          std::memcpy(udst - BPS, &top_u[8 * mb_x], 8);
          std::memcpy(vdst - BPS, &top_v[8 * mb_x], 8);
        }
        const int16_t* coeffs = block.coeffs;
        uint32_t bits = block.non_zero_y;
        if (block.is_i4x4) {
          uint8_t* top_right = ydst - BPS + 16;
          if (mb_y > 0) {
            if (mb_x >= mb_w - 1) std::memset(top_right, top_y[16 * mb_x + 15], 4);
            else std::memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
          }
          for (int k = 1; k <= 3; ++k) std::memcpy(top_right + k * 4 * BPS, top_right, 4);
          for (int n = 0; n < 16; ++n, bits <<= 2) {
            uint8_t* dst = ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
            pred4(dst, block.imodes[n]);
            if (bits >> 30) transform_one(coeffs + n * 16, dst);
          }
        } else {
          pred_large(ydst, 16, check_mode(mb_x, mb_y, block.imodes[0]));
          if (bits)
            for (int n = 0; n < 16; ++n, bits <<= 2)
              if (bits >> 30) transform_one(coeffs + n * 16, ydst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
        pred_large(udst, 8, uvmode);
        pred_large(vdst, 8, uvmode);
        for (int c = 0; c < 2; ++c) {
          uint8_t* dst = c ? vdst : udst;
          if ((block.non_zero_uv >> (8 * c)) & 0xff)
            for (int n = 0; n < 4; ++n)
              transform_one(coeffs + 256 + c * 64 + n * 16, dst + (n & 1) * 4 + (n >> 1) * 4 * BPS);
        }
        if (mb_y < mb_h - 1) {
          std::memcpy(&top_y[16 * mb_x], ydst + 15 * BPS, 16);
          std::memcpy(&top_u[8 * mb_x], udst + 7 * BPS, 8);
          std::memcpy(&top_v[8 * mb_x], vdst + 7 * BPS, 8);
        }
        for (int j = 0; j < 16; ++j)
          std::memcpy(&Y[(size_t)(mb_y * 16 + j) * yw + mb_x * 16], ydst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
          std::memcpy(&U[(size_t)(mb_y * 8 + j) * uvw + mb_x * 8], udst + j * BPS, 8);
          std::memcpy(&V[(size_t)(mb_y * 8 + j) * uvw + mb_x * 8], vdst + j * BPS, 8);
        }
      }
    }
    // the loop filter, macroblock by macroblock in raster order (DoFilter)
    if (filter_type > 0)
      for (int mb_y = 0; mb_y < mb_h; ++mb_y)
        for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
          const FInfo& f = finfo[(size_t)mb_y * mb_w + mb_x];
          if (f.limit == 0) continue;
          uint8_t* yp = &Y[(size_t)mb_y * 16 * yw + mb_x * 16];
          if (filter_type == 1) {
            if (mb_x > 0) simple_filter(yp, 1, yw, f.limit + 4);
            if (f.inner)
              for (int k = 1; k <= 3; ++k) simple_filter(yp + 4 * k, 1, yw, f.limit);
            if (mb_y > 0) simple_filter(yp, yw, 1, f.limit + 4);
            if (f.inner)
              for (int k = 1; k <= 3; ++k) simple_filter(yp + 4 * k * yw, yw, 1, f.limit);
          } else {
            uint8_t* up = &U[(size_t)mb_y * 8 * uvw + mb_x * 8];
            uint8_t* vp = &V[(size_t)mb_y * 8 * uvw + mb_x * 8];
            const int lim = f.limit, il = f.ilevel, ht = f.hev_thresh;
            if (mb_x > 0) {
              filter_loop(yp, 1, yw, 16, lim + 4, il, ht, true);
              filter_loop(up, 1, uvw, 8, lim + 4, il, ht, true);
              filter_loop(vp, 1, uvw, 8, lim + 4, il, ht, true);
            }
            if (f.inner) {
              for (int k = 1; k <= 3; ++k) filter_loop(yp + 4 * k, 1, yw, 16, lim, il, ht, false);
              filter_loop(up + 4, 1, uvw, 8, lim, il, ht, false);
              filter_loop(vp + 4, 1, uvw, 8, lim, il, ht, false);
            }
            if (mb_y > 0) {
              filter_loop(yp, yw, 1, 16, lim + 4, il, ht, true);
              filter_loop(up, uvw, 1, 8, lim + 4, il, ht, true);
              filter_loop(vp, uvw, 1, 8, lim + 4, il, ht, true);
            }
            if (f.inner) {
              for (int k = 1; k <= 3; ++k) filter_loop(yp + 4 * k * yw, yw, 1, 16, lim, il, ht, false);
              filter_loop(up + 4 * uvw, uvw, 1, 8, lim, il, ht, false);
              filter_loop(vp + 4 * uvw, uvw, 1, 8, lim, il, ht, false);
            }
          }
        }
    // YUV 4:2:0 -> BGR (EmitFancyRGB): row 0 alone, then row pairs, then the last row of an even height
    const int w = width, h = height;
    const size_t ostride = (size_t)w * 3;
    upsample_pair(&Y[0], nullptr, &U[0], &V[0], &U[0], &V[0], out, nullptr, w);
    int y = 0;
    for (; y + 2 < h; y += 2) {
      const int cy = y / 2;
      upsample_pair(&Y[(size_t)(y + 1) * yw], &Y[(size_t)(y + 2) * yw], &U[(size_t)cy * uvw], &V[(size_t)cy * uvw],
                    &U[(size_t)(cy + 1) * uvw], &V[(size_t)(cy + 1) * uvw], out + (y + 1) * ostride,
                    out + (y + 2) * ostride, w);
    }
    if (!(h & 1)) {
      const int cy = (h - 1) / 2;
      upsample_pair(&Y[(size_t)(h - 1) * yw], nullptr, &U[(size_t)cy * uvw], &V[(size_t)cy * uvw],
                    &U[(size_t)cy * uvw], &V[(size_t)cy * uvw], out + (h - 1) * ostride, nullptr, w);
    }
    return 0;
  }
};

}  // namespace

extern "C" {

// A VP8L bitstream (from its 0x2f signature byte) -> out [height][width][3] BGR
int webp_vp8l_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t width, int64_t height) {
  if (size < 5 || data[0] != 0x2f) return -1;
  LDecoder dec(data, size);
  dec.br.read(8);
  const int w = (int)dec.br.read(14) + 1, h = (int)dec.br.read(14) + 1;
  dec.br.read(1);  // alpha is used: the colour channels are read either way
  if (dec.br.read(3) != 0) return -1;
  if (w != width || h != height) return -1;
  std::vector<uint32_t> px;
  int xsize = 0;
  if (!dec.decode_stream(w, h, true, px, &xsize)) return -1;
  for (auto it = dec.transforms.rbegin(); it != dec.transforms.rend(); ++it) inverse_transform(*it, px);
  for (int64_t i = 0; i < (int64_t)w * h; ++i) {
    out[3 * i] = (uint8_t)(px[i] & 0xff);
    out[3 * i + 1] = (uint8_t)((px[i] >> 8) & 0xff);
    out[3 * i + 2] = (uint8_t)((px[i] >> 16) & 0xff);
  }
  return 0;
}

// An ALPH chunk's payload for a width x height image -> 0 where libwebp
// decodes it (ALPHDecode: the header byte's method 0, raw, with the plane's
// bytes there, or 1, a VP8L image stream without its header; filter any,
// preprocessing 0 or 1, reserved bits 0), -1 where it fails the image. The
// alpha itself is dropped, as IMREAD_COLOR drops it.
int webp_alpha_check(const uint8_t* data, int64_t size, int64_t width, int64_t height) {
  if (size < 1) return -1;
  const int method = data[0] & 3, pre = (data[0] >> 4) & 3, rsrv = (data[0] >> 6) & 3;
  if (method > 1 || pre > 1 || rsrv != 0) return -1;
  if (method == 0) return size - 1 >= width * height ? 0 : -1;
  LDecoder dec(data + 1, size - 1);
  std::vector<uint32_t> px;
  int xsize = 0;
  return dec.decode_stream((int)width, (int)height, true, px, &xsize) ? 0 : -1;
}

// A VP8 key frame (from its frame tag) -> out [height][width][3] BGR
int webp_vp8_decode(const uint8_t* data, int64_t size, uint8_t* out, int64_t width, int64_t height) {
  VP8 dec;
  if (size >= 10) {
    const int w = ((data[7] << 8) | data[6]) & 0x3fff, h = ((data[9] << 8) | data[8]) & 0x3fff;
    if (w != width || h != height) return -1;
  }
  return dec.decode(data, size, out);
}

}  // extern "C"
