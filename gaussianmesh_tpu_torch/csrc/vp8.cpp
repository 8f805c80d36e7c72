// Lossy WebP's VP8 key frame, as libwebp 1.6 decodes it (the JAX reader
// opens dataset images with PIL, which reaches libwebp; the machines the
// port runs on have neither): every bit, prediction, transform and filter
// step of `src/dec/` and `src/dsp/dec.c`, so the planes equal libwebp's
// `WebPDecodeYUV` byte for byte.
//
// - gm_vp8_decode: a VP8 frame (the payload of a `VP8 ` chunk) -> its Y, U
//   and V planes, cropped to the picture. The boolean decoder reads zeros
//   past a partition's end and sets an end-of-file flag when it needs a
//   byte that is not there; the flag is checked where libwebp checks it,
//   after each macroblock (token partitions) and each macroblock row (the
//   modes), and a set flag fails the decode.
// - gm_vp8_rgb: libwebp's "fancy" chroma upsampler and fixed-point
//   YUV -> RGB (`src/dsp/upsampling.c`, `yuv.h`), the bytes PIL's
//   `convert("RGB")` gives.
// - gm_vp8_encode: a key frame of 16x16 and chroma modes chosen by SSE,
//   1 or 4 segments, any filter and 1-8 token partitions, with the default
//   coefficient probabilities; its reconstruction runs the decoder's own
//   prediction, transform and filter code. For the tests and
//   `chip_smoke.py`, which have no PIL to write WebPs with.
//
// `io/webp.py` parses the RIFF container and holds the plain versions
// (`vp8_decode_plain`, `yuv_to_rgb_plain`) this file is held to. The
// constant tables are libwebp's (the tests find each in libwebp's binary).
// Integer arithmetic wraps as numpy's int32 does (built with -fwrapv), so a
// corrupt stream's out-of-range coefficients give the plain version's bytes.
//
// Host code, not a TPU kernel: built by `ops/_cuda.py::host_library` with
// g++, loaded with ctypes.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// entry-point status codes (io/webp.py names them)
constexpr int kOk = 0;
constexpr int kCutModes = 1;        // the first partition ends before its modes do
constexpr int kCutTokens = 2;       // a token partition ends before its macroblocks do
constexpr int kBadFirstSize = 3;    // the first partition runs past the frame
constexpr int kBadPartitions = 4;   // no room for the partition sizes or the last partition
constexpr int kNoRoom = 5;          // an encoder's output past its buffer

constexpr int BPS = 32;             // the work buffer's stride, as libwebp's
constexpr int Y_OFF = BPS * 1 + 8;
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

// 4x4 sub-block modes in libwebp's order; the 16x16 and chroma modes are
// the first four of them
enum { B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED, B_VR_PRED,
       B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED, NUM_BMODES,
       DC_PRED = B_DC_PRED, V_PRED = B_VE_PRED, H_PRED = B_HE_PRED,
       TM_PRED = B_TM_PRED, DC_NOTOP = 4, DC_NOLEFT = 5, DC_NOTOPLEFT = 6 };

// the 4x4 mode tree (libwebp's kYModesIntra4: leaves are minus the mode)
constexpr int8_t kYModesIntra4[18] = {
    -B_DC_PRED, 1, -B_TM_PRED, 2, -B_VE_PRED, 3, 4, 6, -B_HE_PRED, 5,
    -B_RD_PRED, -B_VR_PRED, -B_LD_PRED, 7, -B_VL_PRED, 8, -B_HD_PRED, -B_HU_PRED};

// extra-bit probabilities of DCT_CAT3..6 (0-terminated)
constexpr uint8_t kCat3[] = {173, 148, 140, 0};
constexpr uint8_t kCat4[] = {176, 155, 140, 135, 0};
constexpr uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
constexpr uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};

// libwebp's constant tables (src/dec/tree_dec.c, quant_dec.c, vp8_dec.c)

const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17, 18, 19, 20, 20,
    21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 36, 37, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 46, 47, 48, 49, 50,
    51, 52, 53, 54, 55, 56, 57, 58, 59, 60, 61, 62, 63, 64, 65, 66, 67, 68,
    69, 70, 71, 72, 73, 74, 75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85,
    86, 87, 88, 89, 91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110,
    112, 114, 116, 118, 122, 124, 126, 128, 130, 132, 134, 136, 138, 140,
    143, 145, 148, 151, 154, 157};

const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23,
    24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41,
    42, 43, 44, 45, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58, 60,
    62, 64, 66, 68, 70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92, 94, 96,
    98, 100, 102, 104, 106, 108, 110, 112, 114, 116, 119, 122, 125, 128, 131,
    134, 137, 140, 143, 146, 149, 152, 155, 158, 161, 164, 167, 170, 173,
    177, 181, 185, 189, 193, 197, 201, 205, 209, 213, 217, 221, 225, 229,
    234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};

const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
            {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {
        {
            {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
            {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255}},
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {
        {
            {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
            {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255}},
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255}},
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}},
    {
        {
            {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255}},
        {
            {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}},
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255}}}};

const uint8_t kBmodesProba[10][10][9] = {
    {
        {231, 120, 48, 89, 115, 113, 120, 152, 112},
        {152, 179, 64, 126, 170, 118, 46, 70, 95},
        {175, 69, 143, 80, 85, 82, 72, 155, 103},
        {56, 58, 10, 171, 218, 189, 17, 13, 152},
        {114, 26, 17, 163, 44, 195, 21, 10, 173},
        {121, 24, 80, 195, 26, 62, 44, 64, 85},
        {144, 71, 10, 38, 171, 213, 144, 34, 26},
        {170, 46, 55, 19, 136, 160, 33, 206, 71},
        {63, 20, 8, 114, 114, 208, 12, 9, 226},
        {81, 40, 11, 96, 182, 84, 29, 16, 36}},
    {
        {134, 183, 89, 137, 98, 101, 106, 165, 148},
        {72, 187, 100, 130, 157, 111, 32, 75, 80},
        {66, 102, 167, 99, 74, 62, 40, 234, 128},
        {41, 53, 9, 178, 241, 141, 26, 8, 107},
        {74, 43, 26, 146, 73, 166, 49, 23, 157},
        {65, 38, 105, 160, 51, 52, 31, 115, 128},
        {104, 79, 12, 27, 217, 255, 87, 17, 7},
        {87, 68, 71, 44, 114, 51, 15, 186, 23},
        {47, 41, 14, 110, 182, 183, 21, 17, 194},
        {66, 45, 25, 102, 197, 189, 23, 18, 22}},
    {
        {88, 88, 147, 150, 42, 46, 45, 196, 205},
        {43, 97, 183, 117, 85, 38, 35, 179, 61},
        {39, 53, 200, 87, 26, 21, 43, 232, 171},
        {56, 34, 51, 104, 114, 102, 29, 93, 77},
        {39, 28, 85, 171, 58, 165, 90, 98, 64},
        {34, 22, 116, 206, 23, 34, 43, 166, 73},
        {107, 54, 32, 26, 51, 1, 81, 43, 31},
        {68, 25, 106, 22, 64, 171, 36, 225, 114},
        {34, 19, 21, 102, 132, 188, 16, 76, 124},
        {62, 18, 78, 95, 85, 57, 50, 48, 51}},
    {
        {193, 101, 35, 159, 215, 111, 89, 46, 111},
        {60, 148, 31, 172, 219, 228, 21, 18, 111},
        {112, 113, 77, 85, 179, 255, 38, 120, 114},
        {40, 42, 1, 196, 245, 209, 10, 25, 109},
        {88, 43, 29, 140, 166, 213, 37, 43, 154},
        {61, 63, 30, 155, 67, 45, 68, 1, 209},
        {100, 80, 8, 43, 154, 1, 51, 26, 71},
        {142, 78, 78, 16, 255, 128, 34, 197, 171},
        {41, 40, 5, 102, 211, 183, 4, 1, 221},
        {51, 50, 17, 168, 209, 192, 23, 25, 82}},
    {
        {138, 31, 36, 171, 27, 166, 38, 44, 229},
        {67, 87, 58, 169, 82, 115, 26, 59, 179},
        {63, 59, 90, 180, 59, 166, 93, 73, 154},
        {40, 40, 21, 116, 143, 209, 34, 39, 175},
        {47, 15, 16, 183, 34, 223, 49, 45, 183},
        {46, 17, 33, 183, 6, 98, 15, 32, 183},
        {57, 46, 22, 24, 128, 1, 54, 17, 37},
        {65, 32, 73, 115, 28, 128, 23, 128, 205},
        {40, 3, 9, 115, 51, 192, 18, 6, 223},
        {87, 37, 9, 115, 59, 77, 64, 21, 47}},
    {
        {104, 55, 44, 218, 9, 54, 53, 130, 226},
        {64, 90, 70, 205, 40, 41, 23, 26, 57},
        {54, 57, 112, 184, 5, 41, 38, 166, 213},
        {30, 34, 26, 133, 152, 116, 10, 32, 134},
        {39, 19, 53, 221, 26, 114, 32, 73, 255},
        {31, 9, 65, 234, 2, 15, 1, 118, 73},
        {75, 32, 12, 51, 192, 255, 160, 43, 51},
        {88, 31, 35, 67, 102, 85, 55, 186, 85},
        {56, 21, 23, 111, 59, 205, 45, 37, 192},
        {55, 38, 70, 124, 73, 102, 1, 34, 98}},
    {
        {125, 98, 42, 88, 104, 85, 117, 175, 82},
        {95, 84, 53, 89, 128, 100, 113, 101, 45},
        {75, 79, 123, 47, 51, 128, 81, 171, 1},
        {57, 17, 5, 71, 102, 57, 53, 41, 49},
        {38, 33, 13, 121, 57, 73, 26, 1, 85},
        {41, 10, 67, 138, 77, 110, 90, 47, 114},
        {115, 21, 2, 10, 102, 255, 166, 23, 6},
        {101, 29, 16, 10, 85, 128, 101, 196, 26},
        {57, 18, 10, 102, 102, 213, 34, 20, 43},
        {117, 20, 15, 36, 163, 128, 68, 1, 26}},
    {
        {102, 61, 71, 37, 34, 53, 31, 243, 192},
        {69, 60, 71, 38, 73, 119, 28, 222, 37},
        {68, 45, 128, 34, 1, 47, 11, 245, 171},
        {62, 17, 19, 70, 146, 85, 55, 62, 70},
        {37, 43, 37, 154, 100, 163, 85, 160, 1},
        {63, 9, 92, 136, 28, 64, 32, 201, 85},
        {75, 15, 9, 9, 64, 255, 184, 119, 16},
        {86, 6, 28, 5, 64, 255, 25, 248, 1},
        {56, 8, 17, 132, 137, 255, 55, 116, 128},
        {58, 15, 20, 82, 135, 57, 26, 121, 40}},
    {
        {164, 50, 31, 137, 154, 133, 25, 35, 218},
        {51, 103, 44, 131, 131, 123, 31, 6, 158},
        {86, 40, 64, 135, 148, 224, 45, 183, 128},
        {22, 26, 17, 131, 240, 154, 14, 1, 209},
        {45, 16, 21, 91, 64, 222, 7, 1, 197},
        {56, 21, 39, 155, 60, 138, 23, 102, 213},
        {83, 12, 13, 54, 192, 255, 68, 47, 28},
        {85, 26, 85, 85, 128, 128, 32, 146, 171},
        {18, 11, 7, 63, 144, 171, 4, 4, 246},
        {35, 27, 10, 146, 174, 171, 12, 26, 128}},
    {
        {190, 80, 35, 99, 180, 80, 126, 54, 45},
        {85, 126, 47, 87, 176, 51, 41, 20, 32},
        {101, 75, 128, 139, 118, 146, 116, 128, 85},
        {56, 41, 15, 176, 236, 85, 37, 9, 62},
        {71, 30, 17, 119, 118, 255, 17, 18, 138},
        {101, 38, 60, 138, 55, 70, 43, 26, 142},
        {146, 36, 19, 30, 171, 255, 97, 27, 20},
        {138, 45, 61, 62, 219, 1, 81, 188, 64},
        {32, 41, 20, 117, 151, 142, 20, 21, 163},
        {112, 19, 12, 61, 195, 128, 48, 4, 24}}};

const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}},
        {
            {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
            {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
            {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128}},
        {
            {1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
            {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
            {78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128}},
        {
            {1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
            {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
            {77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128}},
        {
            {1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
            {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
            {37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128}},
        {
            {1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
            {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
            {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128}},
        {
            {1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
            {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
            {80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128}},
        {
            {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {
        {
            {198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62},
            {131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1},
            {68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128}},
        {
            {1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
            {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
            {81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128}},
        {
            {1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
            {99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
            {23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128}},
        {
            {1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
            {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
            {44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128}},
        {
            {1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
            {94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
            {22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128}},
        {
            {1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
            {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
            {35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128}},
        {
            {1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
            {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
            {45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128}},
        {
            {1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
            {203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128}}},
    {
        {
            {253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
            {175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
            {73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128}},
        {
            {1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
            {239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
            {155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128}},
        {
            {1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
            {201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
            {69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128}},
        {
            {1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
            {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
            {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128}},
        {
            {1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
            {149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {
            {1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {
            {1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
            {213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
            {55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128}},
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128}}},
    {
        {
            {202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
            {126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
            {61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128}},
        {
            {1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
            {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
            {39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128}},
        {
            {1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
            {124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
            {24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128}},
        {
            {1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
            {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
            {28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128}},
        {
            {1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
            {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
            {20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128}},
        {
            {1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
            {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
            {47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128}},
        {
            {1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
            {141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
            {42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128}},
        {
            {1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128}}}};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};

// 4x4 block n's offset in the work buffer, luma then chroma
constexpr int kScanY(int n) { return (n & 3) * 4 + (n >> 2) * 4 * BPS; }
constexpr int kScanUV(int n) { return (n & 1) * 4 + (n >> 1) * 4 * BPS; }

inline int clip(int v, int m) { return v < 0 ? 0 : v > m ? m : v; }
inline uint8_t clip8b(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// ------------------------------------------------------------ bit reader
// libwebp's VP8BitReader loading one byte at a time (its bulk loads give
// the same bits and set the end-of-file flag at the same read)

struct BitReader {
  const uint8_t* buf = nullptr;
  const uint8_t* end = nullptr;
  uint64_t value = 0;
  int bits = -8;                  // bits of `value` not yet consumed, minus 8
  uint32_t range = 254;           // the range minus 1
  int eof = 0;
};

inline void br_load(BitReader& br) {
  if (br.buf < br.end) {
    br.bits += 8;
    br.value = (br.value << 8) | *br.buf++;
  } else if (!br.eof) {           // one byte of zeros past the end, then the flag
    br.value <<= 8;
    br.bits += 8;
    br.eof = 1;
  } else {
    br.bits = 0;
  }
}

void br_init(BitReader& br, const uint8_t* start, size_t size) {
  br.buf = start;
  br.end = start + size;
  br.value = 0;
  br.bits = -8;
  br.range = 254;
  br.eof = 0;
  br_load(br);
}

inline int get_bit(BitReader& br, int prob) {
  uint32_t range = br.range;
  if (br.bits < 0) br_load(br);
  const int pos = br.bits;
  const uint32_t split = (range * (uint32_t)prob) >> 8;
  const uint32_t value = (uint32_t)(br.value >> pos);
  const int bit = value > split;
  if (bit) {
    range -= split;
    br.value -= (uint64_t)(split + 1) << pos;
  } else {
    range = split + 1;
  }
  const int shift = 7 ^ (31 - __builtin_clz(range));
  range <<= shift;
  br.bits -= shift;
  br.range = range - 1;
  return bit;
}

int get_value(BitReader& br, int n) {
  int v = 0;
  while (n-- > 0) v |= get_bit(br, 0x80) << n;
  return v;
}

int get_signed_value(BitReader& br, int n) {
  const int v = get_value(br, n);
  return get_bit(br, 0x80) ? -v : v;
}

// ------------------------------------------------------------ bool encoder
// RFC 6386's, section 7.3

struct BoolEncoder {
  std::vector<uint8_t> out;
  uint32_t range = 255;
  uint32_t bottom = 0;
  int bit_count = 24;

  void add_one() {
    size_t i = out.size();
    while (i > 0 && out[i - 1] == 255) out[--i] = 0;
    if (i > 0) ++out[i - 1];
  }
  void put(int bit, int prob) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    if (bit) {
      bottom += split;
      range -= split;
    } else {
      range = split;
    }
    while (range < 128) {
      range <<= 1;
      if (bottom & (1u << 31)) add_one();
      bottom <<= 1;
      if (!--bit_count) {
        out.push_back((uint8_t)(bottom >> 24));
        bottom &= (1u << 24) - 1;
        bit_count = 8;
      }
    }
  }
  void put_value(int v, int n) {
    while (n-- > 0) put((v >> n) & 1, 0x80);
  }
  void put_signed_value(int v, int n) {
    put_value(v < 0 ? -v : v, n);
    put(v < 0, 0x80);
  }
  void flush() {
    int c = bit_count;
    uint32_t v = bottom;
    if (v & (1u << (32 - c))) add_one();
    v <<= c & 7;
    c >>= 3;
    while (--c >= 0) v <<= 8;
    for (c = 0; c < 4; ++c) {
      out.push_back((uint8_t)(v >> 24));
      v <<= 8;
    }
  }
};

// ------------------------------------------------------------ headers

struct Header {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  int use_segment = 0, update_map = 0, absolute_delta = 1;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  int seg_proba[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;            // 0 none, 1 simple, 2 normal
  int log2_parts = 0;
  int base_q = 0;
  int dq[5] = {0, 0, 0, 0, 0};    // y1 dc, y2 dc, y2 ac, uv dc, uv ac
  int use_skip = 0, skip_p = 0;
  uint8_t proba[4][8][3][11];
};

struct Quant {
  int y1[2], y2[2], uv[2];        // dc, ac
};

struct FInfo {
  int limit = 0, ilevel = 0, inner = 0, hev = 0;
};

void make_quant(const Header& h, Quant dqm[4]) {
  for (int i = 0; i < 4; ++i) {
    int q;
    if (h.use_segment) {
      q = h.quantizer[i] + (h.absolute_delta ? 0 : h.base_q);
    } else if (i > 0) {
      dqm[i] = dqm[0];
      continue;
    } else {
      q = h.base_q;
    }
    Quant& m = dqm[i];
    m.y1[0] = kDcTable[clip(q + h.dq[0], 127)];
    m.y1[1] = kAcTable[clip(q, 127)];
    m.y2[0] = kDcTable[clip(q + h.dq[1], 127)] * 2;
    m.y2[1] = kAcTable[clip(q + h.dq[2], 127)] * 155 / 100;
    if (m.y2[1] < 8) m.y2[1] = 8;
    m.uv[0] = kDcTable[clip(q + h.dq[3], 117)];
    m.uv[1] = kAcTable[clip(q + h.dq[4], 127)];
  }
}

// filter strength per segment and per (not B_PRED, B_PRED)
void make_fstrengths(const Header& h, FInfo f[4][2]) {
  for (int s = 0; s < 4; ++s) {
    int base = h.level;
    if (h.use_segment) base = h.filter_strength[s] + (h.absolute_delta ? 0 : h.level);
    for (int i4 = 0; i4 <= 1; ++i4) {
      FInfo& info = f[s][i4];
      int level = base;
      if (h.use_lf_delta) {
        level += h.ref_lf_delta[0];
        if (i4) level += h.mode_lf_delta[0];
      }
      level = clip(level, 63);
      info = FInfo();
      if (level > 0) {
        int ilevel = level;
        if (h.sharpness > 0) {
          ilevel >>= h.sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - h.sharpness) ilevel = 9 - h.sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        info.ilevel = ilevel;
        info.limit = 2 * level + ilevel;
        info.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      }
      info.inner = i4;
    }
  }
}

// the first partition's header up to the partition count; a status
int parse_header(BitReader& br, Header& h) {
  get_value(br, 1);               // colour space
  get_value(br, 1);               // clamping type
  h.use_segment = get_value(br, 1);
  if (h.use_segment) {
    h.update_map = get_value(br, 1);
    if (get_value(br, 1)) {       // segment data
      h.absolute_delta = get_value(br, 1);
      for (int s = 0; s < 4; ++s)
        h.quantizer[s] = get_value(br, 1) ? get_signed_value(br, 7) : 0;
      for (int s = 0; s < 4; ++s)
        h.filter_strength[s] = get_value(br, 1) ? get_signed_value(br, 6) : 0;
    }
    if (h.update_map)
      for (int s = 0; s < 3; ++s) h.seg_proba[s] = get_value(br, 1) ? get_value(br, 8) : 255;
  }
  if (br.eof) return kCutModes;
  h.simple = get_value(br, 1);
  h.level = get_value(br, 6);
  h.sharpness = get_value(br, 3);
  h.use_lf_delta = get_value(br, 1);
  if (h.use_lf_delta && get_value(br, 1)) {
    for (int i = 0; i < 4; ++i)
      if (get_value(br, 1)) h.ref_lf_delta[i] = get_signed_value(br, 6);
    for (int i = 0; i < 4; ++i)
      if (get_value(br, 1)) h.mode_lf_delta[i] = get_signed_value(br, 6);
  }
  h.filter_type = h.level == 0 ? 0 : h.simple ? 1 : 2;
  if (br.eof) return kCutModes;
  h.log2_parts = get_value(br, 2);
  return kOk;
}

// the quantizer indices, then the coefficient probabilities and the skip
// probability (after the partition sizes, as libwebp reads them)
void parse_quant_proba(BitReader& br, Header& h) {
  h.base_q = get_value(br, 7);
  for (int i = 0; i < 5; ++i) h.dq[i] = get_value(br, 1) ? get_signed_value(br, 4) : 0;
  get_value(br, 1);               // refresh the entropy probabilities: ignored
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p)
          h.proba[t][b][c][p] = get_bit(br, kCoeffsUpdateProba[t][b][c][p])
                                    ? (uint8_t)get_value(br, 8) : kCoeffsProba0[t][b][c][p];
  h.use_skip = get_value(br, 1);
  if (h.use_skip) h.skip_p = get_value(br, 8);
}

// ------------------------------------------------------------ macroblocks

struct MB {
  int segment = 0, skip = 0, is_i4x4 = 0, ymode = 0, uvmode = 0;
  uint8_t imodes[16];
};

struct NzCtx {
  uint8_t nz = 0, nz_dc = 0;      // bits 0-3 luma columns / rows, 4-5 U, 6-7 V
};

// statistics of a decode, for the tests (int64 slots of `info`)
enum { kStatFailX = 0, kStatFailY, kStatFilter, kStatSegments, kStatMap, kStatParts,
       kStatI4, kStatSkip, kStatBmodes, kStatTokens = kStatBmodes + 10,
       kStatSharpness = kStatTokens + 11, kStatLfDelta, kStatBaseQ, kStatCount };

void parse_intra_mode(BitReader& br, const Header& h, MB& mb, uint8_t* top, uint8_t* left,
                      int64_t* stats) {
  if (h.update_map) {
    mb.segment = !get_bit(br, h.seg_proba[0]) ? get_bit(br, h.seg_proba[1])
                                              : get_bit(br, h.seg_proba[2]) + 2;
  } else {
    mb.segment = 0;
  }
  mb.skip = h.use_skip ? get_bit(br, h.skip_p) : 0;
  mb.is_i4x4 = !get_bit(br, 145);
  if (!mb.is_i4x4) {
    const int ymode = get_bit(br, 156) ? (get_bit(br, 128) ? TM_PRED : H_PRED)
                                       : (get_bit(br, 163) ? V_PRED : DC_PRED);
    mb.ymode = ymode;
    memset(top, ymode, 4);
    memset(left, ymode, 4);
  } else {
    uint8_t* modes = mb.imodes;
    for (int y = 0; y < 4; ++y) {
      int ymode = left[y];
      for (int x = 0; x < 4; ++x) {
        const uint8_t* prob = kBmodesProba[top[x]][ymode];
        int i = kYModesIntra4[get_bit(br, prob[0])];
        while (i > 0) i = kYModesIntra4[2 * i + get_bit(br, prob[i])];
        ymode = -i;
        top[x] = (uint8_t)ymode;
        ++stats[kStatBmodes + ymode];
      }
      memcpy(modes, top, 4);
      modes += 4;
      left[y] = (uint8_t)ymode;
    }
  }
  mb.uvmode = !get_bit(br, 142) ? DC_PRED : !get_bit(br, 114) ? V_PRED
                                           : get_bit(br, 183) ? TM_PRED : H_PRED;
}

inline int token_of(int v) {
  return v <= 4 ? v : v <= 6 ? 5 : v <= 10 ? 6 : v <= 18 ? 7 : v <= 34 ? 8 : v <= 66 ? 9 : 10;
}

int get_large_value(BitReader& br, const uint8_t* p) {
  int v;
  if (!get_bit(br, p[3])) {
    v = !get_bit(br, p[4]) ? 2 : 3 + get_bit(br, p[5]);
  } else if (!get_bit(br, p[6])) {
    if (!get_bit(br, p[7])) {
      v = 5 + get_bit(br, 159);
    } else {
      v = 7 + 2 * get_bit(br, 165);
      v += get_bit(br, 145);
    }
  } else {
    const int bit1 = get_bit(br, p[8]);
    const int bit0 = get_bit(br, p[9 + bit1]);
    const int cat = 2 * bit1 + bit0;
    v = 0;
    for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + get_bit(br, *tab);
    v += 3 + (8 << cat);
  }
  return v;
}

// one block's tokens from position n -> the position after its last
// token (libwebp's GetCoeffs); `bands` is one plane type's probabilities
int get_coeffs(BitReader& br, const uint8_t (*bands)[3][11], int ctx, const int* dq, int n,
               int16_t* out, int64_t* tokens) {
  const uint8_t* p = bands[kBands[n]][ctx];
  for (; n < 16; ++n) {
    if (!get_bit(br, p[0])) return n;
    while (!get_bit(br, p[1])) {
      ++tokens[0];
      p = bands[kBands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*p_ctx)[11] = bands[kBands[n + 1]];
    int v;
    if (!get_bit(br, p[2])) {
      v = 1;
      p = p_ctx[1];
    } else {
      v = get_large_value(br, p);
      p = p_ctx[2];
    }
    ++tokens[token_of(v)];
    out[kZigzag[n]] = (int16_t)((get_bit(br, 0x80) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

void transform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[0 + i] + in[12 + i];
    const int a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i];
    const int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[0 + i * 4] + 3;
    const int a0 = dc + tmp[3 + i * 4];
    const int a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
    const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4];
    const int a3 = dc - tmp[3 + i * 4];
    out[0] = (int16_t)((a0 + a1) >> 3);
    out[16] = (int16_t)((a3 + a2) >> 3);
    out[32] = (int16_t)((a0 - a1) >> 3);
    out[48] = (int16_t)((a3 - a2) >> 3);
    out += 64;
  }
}

// a macroblock's tokens -> its dequantized coefficients (24 blocks of 16,
// natural order); `nzs` gets each block's token count. Returns 1 where
// libwebp counts the macroblock as having no coefficients.
int parse_residuals(BitReader& br, const Header& h, const Quant& q, const MB& mb, NzCtx& top,
                    NzCtx& left, int16_t* coeffs, int64_t* tokens) {
  memset(coeffs, 0, 384 * sizeof(int16_t));
  int first;
  const uint8_t (*ac)[3][11];
  if (!mb.is_i4x4) {
    int16_t dc[16] = {0};
    const int ctx = top.nz_dc + left.nz_dc;
    const int nz = get_coeffs(br, h.proba[1], ctx, q.y2, 0, dc, tokens);
    top.nz_dc = left.nz_dc = nz > 0;
    transform_wht(dc, coeffs);
    first = 1;
    ac = h.proba[0];
  } else {
    first = 0;
    ac = h.proba[3];
  }
  int non_zero = 0;
  int tnz = top.nz, lnz = left.nz;
  int16_t* dst = coeffs;
  for (int y = 0; y < 4; ++y) {
    int l = (lnz >> y) & 1;
    for (int x = 0; x < 4; ++x) {
      const int ctx = l + ((tnz >> x) & 1);
      const int nz = get_coeffs(br, ac, ctx, q.y1, first, dst, tokens);
      l = nz > first;
      tnz = (tnz & ~(1 << x)) | (l << x);
      non_zero |= nz > 1 || dst[0] != 0;
      dst += 16;
    }
    lnz = (lnz & ~(1 << y)) | (l << y);
  }
  for (int ch = 0; ch < 2; ++ch) {
    for (int y = 0; y < 2; ++y) {
      const int lb = 4 + 2 * ch + y;
      int l = (lnz >> lb) & 1;
      for (int x = 0; x < 2; ++x) {
        const int tb = 4 + 2 * ch + x;
        const int ctx = l + ((tnz >> tb) & 1);
        const int nz = get_coeffs(br, h.proba[2], ctx, q.uv, 0, dst, tokens);
        l = nz > 0;
        tnz = (tnz & ~(1 << tb)) | (l << tb);
        non_zero |= nz > 1 || dst[0] != 0;
        dst += 16;
      }
      lnz = (lnz & ~(1 << lb)) | (l << lb);
    }
  }
  top.nz = (uint8_t)tnz;
  left.nz = (uint8_t)lnz;
  return !non_zero;
}

// ------------------------------------------------------------ prediction
// libwebp's dsp/dec.c predictors on the BPS-strided work buffer

#define DST(x, y) dst[(x) + (y) * BPS]
inline uint8_t avg3(int a, int b, int c) { return (uint8_t)((a + 2 * b + c + 2) >> 2); }
inline uint8_t avg2(int a, int b) { return (uint8_t)((a + b + 1) >> 1); }

void true_motion(uint8_t* dst, int size) {
  const uint8_t* top = dst - BPS;
  const int tl = top[-1];
  for (int y = 0; y < size; ++y) {
    const int l = dst[-1];
    for (int x = 0; x < size; ++x) dst[x] = clip8b(top[x] + l - tl);
    dst += BPS;
  }
}

void fill(uint8_t* dst, int v, int size) {
  for (int j = 0; j < size; ++j) memset(dst + j * BPS, v, size);
}

void pred16(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = 16;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS] + dst[j - BPS];
      fill(dst, dc >> 5, 16);
      break;
    case TM_PRED: true_motion(dst, 16); break;
    case V_PRED:
      for (int j = 0; j < 16; ++j) memcpy(dst + j * BPS, dst - BPS, 16);
      break;
    case H_PRED:
      for (int j = 0; j < 16; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 16);
      break;
    case DC_NOTOP:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 4, 16);
      break;
    case DC_NOLEFT:
      dc = 8;
      for (int j = 0; j < 16; ++j) dc += dst[j - BPS];
      fill(dst, dc >> 4, 16);
      break;
    default: fill(dst, 0x80, 16); break;
  }
}

void pred8(int mode, uint8_t* dst) {
  int dc;
  switch (mode) {
    case DC_PRED:
      dc = 8;
      for (int j = 0; j < 8; ++j) dc += dst[j - BPS] + dst[-1 + j * BPS];
      fill(dst, dc >> 4, 8);
      break;
    case TM_PRED: true_motion(dst, 8); break;
    case V_PRED:
      for (int j = 0; j < 8; ++j) memcpy(dst + j * BPS, dst - BPS, 8);
      break;
    case H_PRED:
      for (int j = 0; j < 8; ++j) memset(dst + j * BPS, dst[j * BPS - 1], 8);
      break;
    case DC_NOTOP:
      dc = 4;
      for (int j = 0; j < 8; ++j) dc += dst[-1 + j * BPS];
      fill(dst, dc >> 3, 8);
      break;
    case DC_NOLEFT:
      dc = 4;
      for (int j = 0; j < 8; ++j) dc += dst[j - BPS];
      fill(dst, dc >> 3, 8);
      break;
    default: fill(dst, 0x80, 8); break;
  }
}

void pred4(int mode, uint8_t* dst) {
  const uint8_t* top = dst - BPS;
  const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
  const int E = top[4], F = top[5], G = top[6], H = top[7];
  const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
  switch (mode) {
    case B_DC_PRED: {
      int dc = 4;
      for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
      fill(dst, dc >> 3, 4);
      break;
    }
    case B_TM_PRED: true_motion(dst, 4); break;
    case B_VE_PRED: {
      const uint8_t vals[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int i = 0; i < 4; ++i) memcpy(dst + i * BPS, vals, 4);
      break;
    }
    case B_HE_PRED:
      memset(dst + 0 * BPS, avg3(X, I, J), 4);
      memset(dst + 1 * BPS, avg3(I, J, K), 4);
      memset(dst + 2 * BPS, avg3(J, K, L), 4);
      memset(dst + 3 * BPS, avg3(K, L, L), 4);
      break;
    case B_RD_PRED:
      DST(0, 3) = avg3(J, K, L);
      DST(1, 3) = DST(0, 2) = avg3(I, J, K);
      DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
      DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
      DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
      DST(3, 1) = DST(2, 0) = avg3(C, B, A);
      DST(3, 0) = avg3(D, C, B);
      break;
    case B_VR_PRED:
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
    case B_LD_PRED:
      DST(0, 0) = avg3(A, B, C);
      DST(1, 0) = DST(0, 1) = avg3(B, C, D);
      DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
      DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
      DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
      DST(3, 2) = DST(2, 3) = avg3(F, G, H);
      DST(3, 3) = avg3(G, H, H);
      break;
    case B_VL_PRED:
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
    case B_HD_PRED:
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
    default:  // B_HU_PRED
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

// libwebp's CheckMode: DC at the frame's top or left edge averages what is there
inline int check_mode(int mb_x, int mb_y, int mode) {
  if (mode == B_DC_PRED) {
    if (mb_x == 0) return mb_y == 0 ? DC_NOTOPLEFT : DC_NOLEFT;
    return mb_y == 0 ? DC_NOTOP : DC_PRED;
  }
  return mode;
}

// ------------------------------------------------------------ transforms

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// the inverse DCT of one block added onto `dst` (libwebp's TransformOne)
void transform_add(const int16_t* in, uint8_t* dst) {
  int C[16];
  int* tmp = C;
  for (int i = 0; i < 4; ++i) {   // vertical pass
    const int a = in[0] + in[8];
    const int b = in[0] - in[8];
    const int c = mul2(in[4]) - mul1(in[12]);
    const int d = mul1(in[4]) + mul2(in[12]);
    tmp[0] = a + d;
    tmp[1] = b + c;
    tmp[2] = b - c;
    tmp[3] = a - d;
    tmp += 4;
    ++in;
  }
  tmp = C;
  for (int i = 0; i < 4; ++i) {   // horizontal pass
    const int dc = tmp[0] + 4;
    const int a = dc + tmp[8];
    const int b = dc - tmp[8];
    const int c = mul2(tmp[4]) - mul1(tmp[12]);
    const int d = mul1(tmp[4]) + mul2(tmp[12]);
    dst[0] = clip8b(dst[0] + ((a + d) >> 3));
    dst[1] = clip8b(dst[1] + ((b + c) >> 3));
    dst[2] = clip8b(dst[2] + ((b - c) >> 3));
    dst[3] = clip8b(dst[3] + ((a - d) >> 3));
    ++tmp;
    dst += BPS;
  }
}

inline void transform_add_nz(const int16_t* in, uint8_t* dst) {
  for (int i = 0; i < 16; ++i)
    if (in[i]) {
      transform_add(in, dst);
      return;
    }
}

// ------------------------------------------------------------ reconstruction

struct Recon {
  int mb_w, mb_h;
  uint8_t yuv[YUV_SIZE];
  std::vector<uint8_t> top_y, top_u, top_v;   // each column's unfiltered bottom row
  std::vector<uint8_t> Y, U, V;               // the padded frame
  int ys, uvs;

  Recon(int w, int h) : mb_w(w), mb_h(h), top_y(16 * w), top_u(8 * w), top_v(8 * w),
                        Y((size_t)256 * w * h), U((size_t)64 * w * h), V((size_t)64 * w * h),
                        ys(16 * w), uvs(8 * w) {
    memset(yuv, 0, sizeof(yuv));
  }

  // libwebp's ReconstructRow set-up: left column 129, the corner 129
  // below the first row, 127 above it (top-right included)
  void start_row(int mb_y) {
    uint8_t* y = yuv + Y_OFF;
    uint8_t* u = yuv + U_OFF;
    uint8_t* v = yuv + V_OFF;
    for (int j = 0; j < 16; ++j) y[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u[j * BPS - 1] = v[j * BPS - 1] = 129;
    if (mb_y > 0) {
      y[-1 - BPS] = u[-1 - BPS] = v[-1 - BPS] = 129;
    } else {
      memset(y - BPS - 1, 127, 16 + 4 + 1);
      memset(u - BPS - 1, 127, 8 + 1);
      memset(v - BPS - 1, 127, 8 + 1);
    }
  }

  void begin_mb(int mb_x, int mb_y, int is_i4x4) {
    uint8_t* y = yuv + Y_OFF;
    uint8_t* u = yuv + U_OFF;
    uint8_t* v = yuv + V_OFF;
    if (mb_x > 0) {               // the previous macroblock's right columns become the left
      for (int j = -1; j < 16; ++j) memcpy(y + j * BPS - 4, y + j * BPS + 12, 4);
      for (int j = -1; j < 8; ++j) {
        memcpy(u + j * BPS - 4, u + j * BPS + 4, 4);
        memcpy(v + j * BPS - 4, v + j * BPS + 4, 4);
      }
    }
    if (mb_y > 0) {
      memcpy(y - BPS, &top_y[16 * mb_x], 16);
      memcpy(u - BPS, &top_u[8 * mb_x], 8);
      memcpy(v - BPS, &top_v[8 * mb_x], 8);
    }
    if (is_i4x4) {
      uint8_t* top_right = y - BPS + 16;
      if (mb_y > 0) {
        if (mb_x >= mb_w - 1) memset(top_right, top_y[16 * mb_x + 15], 4);
        else memcpy(top_right, &top_y[16 * (mb_x + 1)], 4);
      }
      for (int k = 1; k <= 3; ++k) memcpy(top_right + 4 * k * BPS, top_right, 4);
    }
  }

  // prediction and residuals of a macroblock begun with begin_mb
  void predict_add(const MB& mb, int mb_x, int mb_y, const int16_t* coeffs) {
    uint8_t* y = yuv + Y_OFF;
    if (mb.is_i4x4) {
      for (int n = 0; n < 16; ++n) {
        uint8_t* dst = y + kScanY(n);
        pred4(mb.imodes[n], dst);
        transform_add_nz(coeffs + 16 * n, dst);
      }
    } else {
      pred16(check_mode(mb_x, mb_y, mb.ymode), y);
      for (int n = 0; n < 16; ++n) transform_add_nz(coeffs + 16 * n, y + kScanY(n));
    }
    const int uvmode = check_mode(mb_x, mb_y, mb.uvmode);
    pred8(uvmode, yuv + U_OFF);
    pred8(uvmode, yuv + V_OFF);
    for (int n = 0; n < 4; ++n) {
      transform_add_nz(coeffs + 256 + 16 * n, yuv + U_OFF + kScanUV(n));
      transform_add_nz(coeffs + 320 + 16 * n, yuv + V_OFF + kScanUV(n));
    }
  }

  void end_mb(int mb_x, int mb_y) {
    const uint8_t* y = yuv + Y_OFF;
    const uint8_t* u = yuv + U_OFF;
    const uint8_t* v = yuv + V_OFF;
    if (mb_y < mb_h - 1) {
      memcpy(&top_y[16 * mb_x], y + 15 * BPS, 16);
      memcpy(&top_u[8 * mb_x], u + 7 * BPS, 8);
      memcpy(&top_v[8 * mb_x], v + 7 * BPS, 8);
    }
    for (int j = 0; j < 16; ++j) memcpy(&Y[(size_t)(16 * mb_y + j) * ys + 16 * mb_x], y + j * BPS, 16);
    for (int j = 0; j < 8; ++j) {
      memcpy(&U[(size_t)(8 * mb_y + j) * uvs + 8 * mb_x], u + j * BPS, 8);
      memcpy(&V[(size_t)(8 * mb_y + j) * uvs + 8 * mb_x], v + j * BPS, 8);
    }
  }
};

// ------------------------------------------------------------ loop filter
// libwebp's dsp/dec.c filters, `hstride` across the edge, `vstride` along it

inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

inline void do_filter2(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
}

inline void do_filter4(uint8_t* p, int step) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3);
  const int a2 = sclip2((a + 3) >> 3);
  const int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8b(p1 + a3);
  p[-step] = clip8b(p0 + a2);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a3);
}

inline void do_filter6(uint8_t* p, int step) {
  const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7;
  const int a2 = (18 * a + 63) >> 7;
  const int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8b(p2 + a3);
  p[-2 * step] = clip8b(p1 + a2);
  p[-step] = clip8b(p0 + a1);
  p[0] = clip8b(q0 - a1);
  p[step] = clip8b(q1 - a2);
  p[2 * step] = clip8b(q2 - a3);
}

inline int hev(const uint8_t* p, int step, int thresh) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return std::abs(p1 - p0) > thresh || std::abs(q1 - q0) > thresh;
}

inline int needs_filter(const uint8_t* p, int step, int t) {
  const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  return 4 * std::abs(p0 - q0) + std::abs(p1 - q1) <= t;
}

inline int needs_filter2(const uint8_t* p, int step, int t, int it) {
  const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step];
  const int p0 = p[-step], q0 = p[0];
  const int q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
  if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return 0;
  return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
         std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

void simple_edge(uint8_t* p, int hstride, int vstride, int thresh) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < 16; ++i, p += vstride)
    if (needs_filter(p, hstride, thresh2)) do_filter2(p, hstride);
}

// a macroblock edge (6 taps where the variance is low) or an inner one (4)
void normal_edge(uint8_t* p, int hstride, int vstride, int size, int thresh, int ithresh,
                 int hev_thresh, int inner) {
  const int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i, p += vstride) {
    if (!needs_filter2(p, hstride, thresh2, ithresh)) continue;
    if (hev(p, hstride, hev_thresh)) do_filter2(p, hstride);
    else if (inner) do_filter4(p, hstride);
    else do_filter6(p, hstride);
  }
}

// libwebp's DoFilter over every macroblock in order, on the padded frame
void loop_filter(Recon& r, int filter_type, const std::vector<FInfo>& finfo) {
  if (filter_type == 0) return;
  for (int mb_y = 0; mb_y < r.mb_h; ++mb_y) {
    for (int mb_x = 0; mb_x < r.mb_w; ++mb_x) {
      const FInfo& f = finfo[(size_t)mb_y * r.mb_w + mb_x];
      const int limit = f.limit;
      if (limit == 0) continue;
      const int ys = r.ys;
      uint8_t* y = &r.Y[(size_t)16 * mb_y * ys + 16 * mb_x];
      if (filter_type == 1) {
        if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k, 1, ys, limit);
        if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
        if (f.inner)
          for (int k = 1; k <= 3; ++k) simple_edge(y + 4 * k * ys, ys, 1, limit);
        continue;
      }
      const int uvs = r.uvs;
      uint8_t* u = &r.U[(size_t)8 * mb_y * uvs + 8 * mb_x];
      uint8_t* v = &r.V[(size_t)8 * mb_y * uvs + 8 * mb_x];
      const int il = f.ilevel, hv = f.hev;
      if (mb_x > 0) {
        normal_edge(y, 1, ys, 16, limit + 4, il, hv, 0);
        normal_edge(u, 1, uvs, 8, limit + 4, il, hv, 0);
        normal_edge(v, 1, uvs, 8, limit + 4, il, hv, 0);
      }
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) normal_edge(y + 4 * k, 1, ys, 16, limit, il, hv, 1);
        normal_edge(u + 4, 1, uvs, 8, limit, il, hv, 1);
        normal_edge(v + 4, 1, uvs, 8, limit, il, hv, 1);
      }
      if (mb_y > 0) {
        normal_edge(y, ys, 1, 16, limit + 4, il, hv, 0);
        normal_edge(u, uvs, 1, 8, limit + 4, il, hv, 0);
        normal_edge(v, uvs, 1, 8, limit + 4, il, hv, 0);
      }
      if (f.inner) {
        for (int k = 1; k <= 3; ++k) normal_edge(y + 4 * k * ys, ys, 1, 16, limit, il, hv, 1);
        normal_edge(u + 4 * uvs, uvs, 1, 8, limit, il, hv, 1);
        normal_edge(v + 4 * uvs, uvs, 1, 8, limit, il, hv, 1);
      }
    }
  }
}

void crop(const Recon& r, int width, int height, uint8_t* y, uint8_t* u, uint8_t* v) {
  const int uw = (width + 1) / 2, uh = (height + 1) / 2;
  for (int j = 0; j < height; ++j) memcpy(y + (size_t)j * width, &r.Y[(size_t)j * r.ys], width);
  for (int j = 0; j < uh; ++j) {
    memcpy(u + (size_t)j * uw, &r.U[(size_t)j * r.uvs], uw);
    memcpy(v + (size_t)j * uw, &r.V[(size_t)j * r.uvs], uw);
  }
}

// ------------------------------------------------------------ YUV -> RGB

inline int mult_hi(int v, int c) { return (v * c) >> 8; }
inline uint8_t clip_yuv(int v) { return (v & ~16383) == 0 ? (uint8_t)(v >> 6) : v < 0 ? 0 : 255; }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  rgb[0] = clip_yuv(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
  rgb[1] = clip_yuv(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
  rgb[2] = clip_yuv(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
}

// one output row of libwebp's UpsampleRgbLinePair: the row above the pair's
// middle (`bottom` 0) or below it (1), from chroma rows `tu`/`tv` (top) and
// `cu`/`cv` (current)
void upsample_row(const uint8_t* y, const uint8_t* tu, const uint8_t* tv, const uint8_t* cu,
                  const uint8_t* cv, int bottom, int len, uint8_t* dst) {
  int tl_u = tu[0], tl_v = tv[0], l_u = cu[0], l_v = cv[0];
  auto edge = [&](int x) {
    const int u = bottom ? (3 * l_u + tl_u + 2) >> 2 : (3 * tl_u + l_u + 2) >> 2;
    const int v = bottom ? (3 * l_v + tl_v + 2) >> 2 : (3 * tl_v + l_v + 2) >> 2;
    yuv_to_rgb(y[x], u, v, dst + 3 * x);
  };
  edge(0);
  const int last_pair = (len - 1) >> 1;
  for (int x = 1; x <= last_pair; ++x) {
    const int t_u = tu[x], t_v = tv[x], c_u = cu[x], c_v = cv[x];
    const int avg_u = tl_u + t_u + l_u + c_u + 8, avg_v = tl_v + t_v + l_v + c_v + 8;
    const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
    const int d03_u = (avg_u + 2 * (tl_u + c_u)) >> 3, d03_v = (avg_v + 2 * (tl_v + c_v)) >> 3;
    if (!bottom) {
      yuv_to_rgb(y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, dst + 3 * (2 * x - 1));
      yuv_to_rgb(y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, dst + 3 * (2 * x));
    } else {
      yuv_to_rgb(y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1, dst + 3 * (2 * x - 1));
      yuv_to_rgb(y[2 * x], (d12_u + c_u) >> 1, (d12_v + c_v) >> 1, dst + 3 * (2 * x));
    }
    tl_u = t_u; tl_v = t_v; l_u = c_u; l_v = c_v;
  }
  if (!(len & 1)) edge(len - 1);
}

// ------------------------------------------------------------ encoder pieces

// libwebp's forward DCT (enc/dsp): a 4x4 block of src - ref
void ftransform(const uint8_t* src, int src_stride, const uint8_t* ref, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i, src += src_stride, ref += BPS) {
    const int d0 = src[0] - ref[0], d1 = src[1] - ref[1];
    const int d2 = src[2] - ref[2], d3 = src[3] - ref[3];
    const int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
    tmp[0 + i * 4] = (a0 + a1) * 8;
    tmp[1 + i * 4] = (a2 * 2217 + a3 * 5352 + 1812) >> 9;
    tmp[2 + i * 4] = (a0 - a1) * 8;
    tmp[3 + i * 4] = (a3 * 2217 - a2 * 5352 + 937) >> 9;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[12 + i], a1 = tmp[4 + i] + tmp[8 + i];
    const int a2 = tmp[4 + i] - tmp[8 + i], a3 = tmp[0 + i] - tmp[12 + i];
    out[0 + i] = (int16_t)((a0 + a1 + 7) >> 4);
    out[4 + i] = (int16_t)(((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a2 != 0));
    out[8 + i] = (int16_t)((a0 - a1 + 7) >> 4);
    out[12 + i] = (int16_t)((a3 * 2217 - a2 * 5352 + 51000) >> 16);
  }
}

// libwebp's forward WHT of the 16 luma DCs (natural order in, natural out)
void ftransform_wht(const int16_t* in, int16_t* out) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[4 * i + 0] + in[4 * i + 2];
    const int a1 = in[4 * i + 1] + in[4 * i + 3];
    const int a2 = in[4 * i + 1] - in[4 * i + 3];
    const int a3 = in[4 * i + 0] - in[4 * i + 2];
    tmp[0 + i * 4] = a0 + a1;
    tmp[1 + i * 4] = a3 + a2;
    tmp[2 + i * 4] = a3 - a2;
    tmp[3 + i * 4] = a0 - a1;
  }
  for (int i = 0; i < 4; ++i) {
    const int a0 = tmp[0 + i] + tmp[8 + i];
    const int a1 = tmp[4 + i] + tmp[12 + i];
    const int a2 = tmp[4 + i] - tmp[12 + i];
    const int a3 = tmp[0 + i] - tmp[8 + i];
    out[0 + i] = (int16_t)((a0 + a1) >> 1);
    out[4 + i] = (int16_t)((a3 + a2) >> 1);
    out[8 + i] = (int16_t)((a3 - a2) >> 1);
    out[12 + i] = (int16_t)((a0 - a1) >> 1);
  }
}

inline int quantize(int c, int q) {
  const int level = (std::abs(c) + (q >> 1)) / q;
  const int m = level > 2047 ? 2047 : level;
  return c < 0 ? -m : m;
}

// a block's levels (zig-zag order) -> its tokens (the mirror of get_coeffs);
// returns the token count get_coeffs will return
int put_coeffs(BoolEncoder& bw, const uint8_t (*bands)[3][11], int ctx, int first,
               const int* levels) {
  int last = -1;
  for (int i = first; i < 16; ++i)
    if (levels[i]) last = i;
  int n = first;
  const uint8_t* p = bands[kBands[n]][ctx];
  if (last < 0) {
    bw.put(0, p[0]);
    return first;
  }
  while (true) {
    bw.put(1, p[0]);
    while (!levels[n]) {
      bw.put(0, p[1]);
      p = bands[kBands[++n]][0];
    }
    bw.put(1, p[1]);
    const int v = std::abs(levels[n]);
    int next;
    if (v == 1) {
      bw.put(0, p[2]);
      next = 1;
    } else {
      bw.put(1, p[2]);
      next = 2;
      if (v <= 4) {
        bw.put(0, p[3]);
        if (v == 2) {
          bw.put(0, p[4]);
        } else {
          bw.put(1, p[4]);
          bw.put(v == 4, p[5]);
        }
      } else if (v <= 10) {
        bw.put(1, p[3]);
        bw.put(0, p[6]);
        if (v <= 6) {
          bw.put(0, p[7]);
          bw.put(v == 6, 159);
        } else {
          bw.put(1, p[7]);
          bw.put((v - 7) >> 1, 165);
          bw.put((v - 7) & 1, 145);
        }
      } else {
        bw.put(1, p[3]);
        bw.put(1, p[6]);
        const int cat = v < 19 ? 0 : v < 35 ? 1 : v < 67 ? 2 : 3;
        bw.put(cat >> 1, p[8]);
        bw.put(cat & 1, p[9 + (cat >> 1)]);
        const int extra = v - (3 + (8 << cat));
        const uint8_t* tab = kCat3456[cat];
        const int nbits = (int)strlen((const char*)tab);
        for (int i = 0; i < nbits; ++i) bw.put((extra >> (nbits - 1 - i)) & 1, tab[i]);
      }
    }
    bw.put(levels[n] < 0, 0x80);
    ++n;
    if (n == 16) return 16;
    p = bands[kBands[n]][next];
    if (n > last) {
      bw.put(0, p[0]);
      return n;
    }
  }
}

struct EncMB {
  MB mb;
  int levels[25][16];             // 0-15 luma, 16-19 U, 20-23 V, 24 Y2; zig-zag order
};

void write_header(BoolEncoder& bw, const Header& h) {
  bw.put_value(0, 1);             // colour space
  bw.put_value(0, 1);             // clamping type
  bw.put_value(h.use_segment, 1);
  if (h.use_segment) {
    bw.put_value(h.update_map, 1);
    bw.put_value(1, 1);           // segment data follow
    bw.put_value(h.absolute_delta, 1);
    for (int s = 0; s < 4; ++s) {
      bw.put_value(1, 1);
      bw.put_signed_value(h.quantizer[s], 7);
    }
    for (int s = 0; s < 4; ++s) {
      bw.put_value(1, 1);
      bw.put_signed_value(h.filter_strength[s], 6);
    }
    if (h.update_map)
      for (int s = 0; s < 3; ++s) {
        bw.put_value(1, 1);
        bw.put_value(h.seg_proba[s], 8);
      }
  }
  bw.put_value(h.simple, 1);
  bw.put_value(h.level, 6);
  bw.put_value(h.sharpness, 3);
  bw.put_value(h.use_lf_delta, 1);
  if (h.use_lf_delta) {
    bw.put_value(1, 1);           // deltas follow
    for (int i = 0; i < 4; ++i) {
      bw.put_value(1, 1);
      bw.put_signed_value(h.ref_lf_delta[i], 6);
    }
    for (int i = 0; i < 4; ++i) {
      bw.put_value(1, 1);
      bw.put_signed_value(h.mode_lf_delta[i], 6);
    }
  }
  bw.put_value(h.log2_parts, 2);
  bw.put_value(h.base_q, 7);
  for (int i = 0; i < 5; ++i) bw.put_value(0, 1);   // no quantizer deltas
  bw.put_value(0, 1);             // refresh entropy probabilities
  for (int t = 0; t < 4; ++t)
    for (int b = 0; b < 8; ++b)
      for (int c = 0; c < 3; ++c)
        for (int p = 0; p < 11; ++p) bw.put(0, kCoeffsUpdateProba[t][b][c][p]);
  bw.put_value(1, 1);             // mb_no_coeff_skip
  bw.put_value(h.skip_p, 8);
}

void write_modes(BoolEncoder& bw, const Header& h, const MB& mb) {
  if (h.update_map) {
    bw.put(mb.segment >= 2, h.seg_proba[0]);
    if (mb.segment < 2) bw.put(mb.segment == 1, h.seg_proba[1]);
    else bw.put(mb.segment == 3, h.seg_proba[2]);
  }
  bw.put(mb.skip, h.skip_p);
  bw.put(1, 145);                 // not B_PRED
  switch (mb.ymode) {
    case TM_PRED: bw.put(1, 156); bw.put(1, 128); break;
    case H_PRED: bw.put(1, 156); bw.put(0, 128); break;
    case V_PRED: bw.put(0, 156); bw.put(1, 163); break;
    default: bw.put(0, 156); bw.put(0, 163); break;
  }
  switch (mb.uvmode) {
    case DC_PRED: bw.put(0, 142); break;
    case V_PRED: bw.put(1, 142); bw.put(0, 114); break;
    case TM_PRED: bw.put(1, 142); bw.put(1, 114); bw.put(1, 183); break;
    default: bw.put(1, 142); bw.put(1, 114); bw.put(0, 183); break;
  }
}

// a macroblock's tokens with the decoder's contexts (parse_residuals' mirror)
void write_residuals(BoolEncoder& bw, const Header& h, const EncMB& e, NzCtx& top, NzCtx& left) {
  const int ctx = top.nz_dc + left.nz_dc;
  const int nzdc = put_coeffs(bw, h.proba[1], ctx, 0, e.levels[24]);
  top.nz_dc = left.nz_dc = nzdc > 0;
  int tnz = top.nz, lnz = left.nz;
  for (int y = 0; y < 4; ++y) {
    int l = (lnz >> y) & 1;
    for (int x = 0; x < 4; ++x) {
      const int c = l + ((tnz >> x) & 1);
      l = put_coeffs(bw, h.proba[0], c, 1, e.levels[4 * y + x]) > 1;
      tnz = (tnz & ~(1 << x)) | (l << x);
    }
    lnz = (lnz & ~(1 << y)) | (l << y);
  }
  for (int ch = 0; ch < 2; ++ch) {
    for (int y = 0; y < 2; ++y) {
      const int lb = 4 + 2 * ch + y;
      int l = (lnz >> lb) & 1;
      for (int x = 0; x < 2; ++x) {
        const int tb = 4 + 2 * ch + x;
        const int c = l + ((tnz >> tb) & 1);
        l = put_coeffs(bw, h.proba[2], c, 0, e.levels[16 + 4 * ch + 2 * y + x]) > 0;
        tnz = (tnz & ~(1 << tb)) | (l << tb);
      }
      lnz = (lnz & ~(1 << lb)) | (l << lb);
    }
  }
  top.nz = (uint8_t)tnz;
  left.nz = (uint8_t)lnz;
}

int64_t sse(const uint8_t* src, int stride, const uint8_t* pred, int size) {
  int64_t s = 0;
  for (int j = 0; j < size; ++j)
    for (int i = 0; i < size; ++i) {
      const int d = src[j * stride + i] - pred[j * BPS + i];
      s += d * d;
    }
  return s;
}

}  // namespace

extern "C" {

// a VP8 frame (`data`, n bytes: the frame tag, the start code and sizes,
// the partitions) -> its Y (height x width), U and V ((height + 1) / 2 x
// (width + 1) / 2) planes. `info` (int64 x kStatCount) gets the failing
// macroblock and the decode's statistics. io/webp.py has checked the frame
// tag and the start code.
int gm_vp8_decode(const uint8_t* data, int64_t n, uint8_t* y, uint8_t* u, uint8_t* v,
                  int64_t* info) {
  memset(info, 0, kStatCount * sizeof(int64_t));
  Header h;
  const uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  const int64_t first_size = bits >> 5;
  h.width = ((data[7] << 8) | data[6]) & 0x3fff;
  h.height = ((data[9] << 8) | data[8]) & 0x3fff;
  h.mb_w = (h.width + 15) >> 4;
  h.mb_h = (h.height + 15) >> 4;
  if (first_size > n - 10) return kBadFirstSize;
  BitReader br;
  br_init(br, data + 10, (size_t)first_size);
  int status = parse_header(br, h);
  if (status != kOk) return status;
  // the token partitions: sizes of all but the last, then the data
  const uint8_t* buf = data + 10 + first_size;
  const uint8_t* buf_end = data + n;
  const size_t size = (size_t)(n - 10 - first_size);
  const int last = (1 << h.log2_parts) - 1;
  if (size < (size_t)(3 * last)) return kBadPartitions;
  BitReader parts[8];
  const uint8_t* sz = buf;
  const uint8_t* part_start = buf + 3 * last;
  size_t left = size - 3 * last;
  for (int p = 0; p < last; ++p, sz += 3) {
    size_t psize = sz[0] | (sz[1] << 8) | (sz[2] << 16);
    if (psize > left) psize = left;
    br_init(parts[p], part_start, psize);
    part_start += psize;
    left -= psize;
  }
  br_init(parts[last], part_start, left);
  if (part_start >= buf_end) return kBadPartitions;
  parse_quant_proba(br, h);
  Quant dqm[4];
  make_quant(h, dqm);
  FInfo fstrengths[4][2];
  make_fstrengths(h, fstrengths);
  info[kStatFilter] = h.filter_type;
  info[kStatSegments] = h.use_segment;
  info[kStatMap] = h.update_map;
  info[kStatParts] = last + 1;
  info[kStatSharpness] = h.sharpness;
  info[kStatLfDelta] = h.use_lf_delta;
  info[kStatBaseQ] = h.base_q;

  Recon r(h.mb_w, h.mb_h);
  std::vector<MB> row(h.mb_w);
  std::vector<uint8_t> intra_t(4 * h.mb_w, B_DC_PRED);
  std::vector<NzCtx> nz_top(h.mb_w);
  std::vector<FInfo> finfo((size_t)h.mb_w * h.mb_h);
  std::vector<int16_t> coeffs((size_t)384 * h.mb_w);
  for (int mb_y = 0; mb_y < h.mb_h; ++mb_y) {
    uint8_t intra_l[4];
    memset(intra_l, B_DC_PRED, 4);
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x)
      parse_intra_mode(br, h, row[mb_x], &intra_t[4 * mb_x], intra_l, info);
    if (br.eof) {
      info[kStatFailY] = mb_y;
      return kCutModes;
    }
    BitReader& tbr = parts[mb_y & last];
    NzCtx nz_left;
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
      MB& mb = row[mb_x];
      int16_t* c = &coeffs[(size_t)384 * mb_x];
      int skip = h.use_skip ? mb.skip : 0;
      if (!skip) {
        skip = parse_residuals(tbr, h, dqm[mb.segment], mb, nz_top[mb_x], nz_left, c,
                               info + kStatTokens);
      } else {
        nz_left.nz = nz_top[mb_x].nz = 0;
        if (!mb.is_i4x4) nz_left.nz_dc = nz_top[mb_x].nz_dc = 0;
        memset(c, 0, 384 * sizeof(int16_t));
      }
      info[kStatSkip] += mb.skip;
      info[kStatI4] += mb.is_i4x4;
      FInfo& f = finfo[(size_t)mb_y * h.mb_w + mb_x];
      f = fstrengths[mb.segment][mb.is_i4x4];
      f.inner |= !skip;
      if (tbr.eof) {
        info[kStatFailX] = mb_x;
        info[kStatFailY] = mb_y;
        return kCutTokens;
      }
    }
    r.start_row(mb_y);
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
      r.begin_mb(mb_x, mb_y, row[mb_x].is_i4x4);
      r.predict_add(row[mb_x], mb_x, mb_y, &coeffs[(size_t)384 * mb_x]);
      r.end_mb(mb_x, mb_y);
    }
  }
  loop_filter(r, h.filter_type, finfo);
  crop(r, h.width, h.height, y, u, v);
  return kOk;
}

// Y (height x width), U and V ((height + 1) / 2 x (width + 1) / 2) ->
// (height, width, 3) RGB, libwebp's fancy upsampling
int gm_vp8_rgb(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height,
               uint8_t* out) {
  const int uw = (width + 1) / 2, uh = (height + 1) / 2;
  for (int r = 0; r < height; ++r) {
    int top, cur, bottom;
    if (r == 0) {
      top = cur = 0;
      bottom = 0;
    } else {
      const int k = (r + 1) >> 1;
      top = k - 1;
      cur = k < uh ? k : k - 1;
      bottom = !(r & 1);
    }
    upsample_row(y + (size_t)r * width, u + (size_t)top * uw, v + (size_t)top * uw,
                 u + (size_t)cur * uw, v + (size_t)cur * uw, bottom, width,
                 out + (size_t)3 * r * width);
  }
  return kOk;
}

// A key frame of the padded planes `y` (16 mb_h x 16 mb_w), `u` and `v`
// (8 mb_h x 8 mb_w) of a width x height picture, `seg_map` one segment per
// macroblock and `params` (int32): n_segments, absolute, base_q, quantizer
// [4], filter strength [4], filter type (0 none, 1 simple, 2 normal),
// level, sharpness, use_lf_delta, ref_lf_delta [4], mode_lf_delta [4],
// log2 of the token partitions. -> the frame in `out` (`n_out` bytes) and
// its reconstruction, cropped, in `ry`, `ru`, `rv`.
int gm_vp8_encode(const uint8_t* y, const uint8_t* u, const uint8_t* v, int width, int height,
                  const uint8_t* seg_map, const int32_t* params, uint8_t* out, int64_t cap,
                  int64_t* n_out, uint8_t* ry, uint8_t* ru, uint8_t* rv) {
  Header h;
  h.width = width;
  h.height = height;
  h.mb_w = (width + 15) >> 4;
  h.mb_h = (height + 15) >> 4;
  h.use_segment = params[0] > 1;
  h.update_map = h.use_segment;
  h.absolute_delta = params[1];
  h.base_q = params[2];
  for (int s = 0; s < 4; ++s) {
    h.quantizer[s] = params[3 + s];
    h.filter_strength[s] = params[7 + s];
  }
  h.filter_type = params[11];
  h.simple = h.filter_type == 1;
  h.level = h.filter_type ? params[12] : 0;
  h.sharpness = params[13];
  h.use_lf_delta = params[14];
  for (int i = 0; i < 4; ++i) {
    h.ref_lf_delta[i] = params[15 + i];
    h.mode_lf_delta[i] = params[19 + i];
  }
  h.log2_parts = params[23];
  h.use_skip = 1;
  memcpy(h.proba, kCoeffsProba0, sizeof(h.proba));
  Quant dqm[4];
  make_quant(h, dqm);
  FInfo fstrengths[4][2];
  make_fstrengths(h, fstrengths);
  h.filter_type = h.level == 0 ? 0 : h.simple ? 1 : 2;

  const int ys = 16 * h.mb_w, uvs = 8 * h.mb_w;
  Recon r(h.mb_w, h.mb_h);
  std::vector<EncMB> mbs((size_t)h.mb_w * h.mb_h);
  std::vector<FInfo> finfo(mbs.size());
  int64_t seg_count[4] = {0, 0, 0, 0}, n_skip = 0;
  int16_t coeffs[384];
  for (int mb_y = 0; mb_y < h.mb_h; ++mb_y) {
    r.start_row(mb_y);
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
      EncMB& e = mbs[(size_t)mb_y * h.mb_w + mb_x];
      MB& mb = e.mb;
      mb.segment = h.use_segment ? seg_map[(size_t)mb_y * h.mb_w + mb_x] & 3 : 0;
      ++seg_count[mb.segment];
      const Quant& q = dqm[mb.segment];
      const uint8_t* sy = y + (size_t)16 * mb_y * ys + 16 * mb_x;
      const uint8_t* su = u + (size_t)8 * mb_y * uvs + 8 * mb_x;
      const uint8_t* sv = v + (size_t)8 * mb_y * uvs + 8 * mb_x;
      uint8_t* py = r.yuv + Y_OFF;
      uint8_t* pu = r.yuv + U_OFF;
      uint8_t* pv = r.yuv + V_OFF;
      r.begin_mb(mb_x, mb_y, 0);
      int64_t best = -1;
      for (int m : {DC_PRED, TM_PRED, V_PRED, H_PRED}) {
        pred16(check_mode(mb_x, mb_y, m), py);
        const int64_t s = sse(sy, ys, py, 16);
        if (best < 0 || s < best) {
          best = s;
          mb.ymode = m;
        }
      }
      best = -1;
      for (int m : {DC_PRED, TM_PRED, V_PRED, H_PRED}) {
        pred8(check_mode(mb_x, mb_y, m), pu);
        pred8(check_mode(mb_x, mb_y, m), pv);
        const int64_t s = sse(su, uvs, pu, 8) + sse(sv, uvs, pv, 8);
        if (best < 0 || s < best) {
          best = s;
          mb.uvmode = m;
        }
      }
      pred16(check_mode(mb_x, mb_y, mb.ymode), py);
      pred8(check_mode(mb_x, mb_y, mb.uvmode), pu);
      pred8(check_mode(mb_x, mb_y, mb.uvmode), pv);
      // residuals -> levels -> the decoder's dequantized coefficients
      memset(coeffs, 0, sizeof(coeffs));
      int16_t blk[16], dcs[16], y2[16], dq_dc[16];
      int nzs[24];
      for (int n = 0; n < 16; ++n) {
        ftransform(sy + (n >> 2) * 4 * ys + (n & 3) * 4, ys, py + kScanY(n), blk);
        dcs[n] = blk[0];
        e.levels[n][0] = 0;
        nzs[n] = 1;
        for (int k = 1; k < 16; ++k) {
          const int lv = quantize(blk[kZigzag[k]], q.y1[1]);
          e.levels[n][k] = lv;
          coeffs[16 * n + kZigzag[k]] = (int16_t)(lv * q.y1[1]);
          if (lv) nzs[n] = k + 1;
        }
      }
      ftransform_wht(dcs, y2);
      memset(dq_dc, 0, sizeof(dq_dc));
      for (int k = 0; k < 16; ++k) {
        const int qk = q.y2[k > 0];
        const int lv = quantize(y2[kZigzag[k]], qk);
        e.levels[24][k] = lv;
        dq_dc[kZigzag[k]] = (int16_t)(lv * qk);
      }
      int16_t wht_out[256];
      transform_wht(dq_dc, wht_out);
      for (int n = 0; n < 16; ++n) coeffs[16 * n] = wht_out[16 * n];
      for (int ch = 0; ch < 2; ++ch) {
        const uint8_t* s = ch ? sv : su;
        const uint8_t* p = ch ? pv : pu;
        for (int n = 0; n < 4; ++n) {
          const int b = 16 + 4 * ch + n;
          ftransform(s + (n >> 1) * 4 * uvs + (n & 1) * 4, uvs, p + kScanUV(n), blk);
          nzs[b] = 0;
          for (int k = 0; k < 16; ++k) {
            const int qk = q.uv[k > 0];
            const int lv = quantize(blk[kZigzag[k]], qk);
            e.levels[b][k] = lv;
            coeffs[16 * b + kZigzag[k]] = (int16_t)(lv * qk);
            if (lv) nzs[b] = k + 1;
          }
        }
      }
      int any = 0, non_zero = 0;
      for (int b = 0; b < 25; ++b)
        for (int k = 0; k < 16; ++k) any |= e.levels[b][k] != 0;
      for (int b = 0; b < 24; ++b) non_zero |= nzs[b] > 1 || coeffs[16 * b] != 0;
      mb.skip = !any;
      n_skip += mb.skip;
      mb.is_i4x4 = 0;
      r.predict_add(mb, mb_x, mb_y, coeffs);
      r.end_mb(mb_x, mb_y);
      FInfo& f = finfo[(size_t)mb_y * h.mb_w + mb_x];
      f = fstrengths[mb.segment][0];
      f.inner |= non_zero;
    }
  }
  loop_filter(r, h.filter_type, finfo);
  crop(r, width, height, ry, ru, rv);

  // probabilities of the segment tree and of the skip flag from the counts
  auto proba_of = [](int64_t zeros, int64_t total) {
    if (total == 0) return 255;
    const int p = (int)((255 * zeros + total / 2) / total);
    return p < 1 ? 1 : p > 255 ? 255 : p;
  };
  const int64_t n_mb = (int64_t)mbs.size();
  h.seg_proba[0] = proba_of(seg_count[0] + seg_count[1], n_mb);
  h.seg_proba[1] = proba_of(seg_count[0], seg_count[0] + seg_count[1]);
  h.seg_proba[2] = proba_of(seg_count[2], seg_count[2] + seg_count[3]);
  h.skip_p = proba_of(n_mb - n_skip, n_mb);

  BoolEncoder first;
  write_header(first, h);
  const int n_parts = 1 << h.log2_parts;
  std::vector<BoolEncoder> parts(n_parts);
  std::vector<NzCtx> nz_top(h.mb_w);
  for (int mb_y = 0; mb_y < h.mb_h; ++mb_y) {
    NzCtx nz_left;
    BoolEncoder& tbw = parts[mb_y & (n_parts - 1)];
    for (int mb_x = 0; mb_x < h.mb_w; ++mb_x) {
      const EncMB& e = mbs[(size_t)mb_y * h.mb_w + mb_x];
      write_modes(first, h, e.mb);
      if (e.mb.skip) {
        nz_left.nz = nz_top[mb_x].nz = 0;
        nz_left.nz_dc = nz_top[mb_x].nz_dc = 0;
      } else {
        write_residuals(tbw, h, e, nz_top[mb_x], nz_left);
      }
    }
  }
  first.flush();
  for (auto& p : parts) p.flush();
  int64_t total = 10 + (int64_t)first.out.size() + 3 * (n_parts - 1);
  for (auto& p : parts) total += (int64_t)p.out.size();
  *n_out = total;
  if (total > cap) return kNoRoom;
  if (first.out.size() >= (1u << 19)) return kNoRoom;
  const uint32_t tag = 0 | (0 << 1) | (1 << 4) | ((uint32_t)first.out.size() << 5);
  uint8_t* o = out;
  *o++ = tag & 0xff;
  *o++ = (tag >> 8) & 0xff;
  *o++ = (tag >> 16) & 0xff;
  *o++ = 0x9d;
  *o++ = 0x01;
  *o++ = 0x2a;
  *o++ = width & 0xff;
  *o++ = (width >> 8) & 0x3f;
  *o++ = height & 0xff;
  *o++ = (height >> 8) & 0x3f;
  memcpy(o, first.out.data(), first.out.size());
  o += first.out.size();
  for (int p = 0; p < n_parts - 1; ++p) {
    const size_t s = parts[p].out.size();
    *o++ = s & 0xff;
    *o++ = (s >> 8) & 0xff;
    *o++ = (s >> 16) & 0xff;
  }
  for (auto& p : parts) {
    memcpy(o, p.out.data(), p.out.size());
    o += p.out.size();
  }
  return kOk;
}

}  // extern "C"
