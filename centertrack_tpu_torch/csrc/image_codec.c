/* Host image codec of the port: baseline JPEG decoding and encoding that
 * give what cv2.imread / cv2.imencode give (OpenCV over libjpeg-turbo at
 * its defaults), bit for bit, and PNG's row filters undone.
 *
 * Plain C, no CUDA: built with the host compiler (`cc -O2 -shared -fPIC`)
 * by ops/_build.build_host and bound with ctypes by utils/jpeg.py. Every
 * entry point works on caller-owned buffers and returns a status:
 * CODEC_OK, CODEC_UNSUPPORTED (a valid file of a kind not decoded here:
 * progressive, arithmetic, 12-bit, CMYK, sampling factors above 2),
 * CODEC_CORRUPT (truncated or malformed data) or CODEC_SMALL (the output
 * buffer is too small), with a message in `msg`.
 *
 * Decoding follows libjpeg-turbo's defaults, each pinned by a test
 * against cv2.imread (tests/test_torch_port_codec.py):
 *  - the ISLOW integer IDCT (jidctint.c), its range-limit table included;
 *  - fancy upsampling: jdsample.c's h2v1 and h2v2 triangle filters (and
 *    h1v2's), plain replication where a chroma row has <= 2 samples,
 *    context rows replicated at the image's top and bottom;
 *  - jdcolor.c's fixed-point YCbCr -> RGB tables; gray replicated to three
 *    channels; Adobe transform 0 (or R, G, B component ids) read as RGB.
 * Encoding reproduces cv2.imencode('.jpg') at a given quality: the JFIF
 * APP0, jcparam.c's quality scaling of the Annex K tables (baseline),
 * jccolor.c's RGB -> YCbCr, jcsample.c's h2v2 downsampling with its
 * alternating bias and libjpeg's edge padding, the ISLOW FDCT (jfdctint.c)
 * with jcdctmgr.c's reciprocal quantization (the 16-bit form of the SIMD
 * build), dummy blocks at the MCU edges, and the standard Huffman tables.
 * A gray image gives one component, as cv2 does.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

enum { CODEC_OK = 0, CODEC_UNSUPPORTED = 1, CODEC_CORRUPT = 2,
       CODEC_SMALL = 3, CODEC_NOMEM = 4 };

/* the zigzag order: coefficient k of a scan is natural index ZZ[k] */
static const uint8_t ZZ[64] = {
   0,  1,  8, 16,  9,  2,  3, 10, 17, 24, 32, 25, 18, 11,  4,  5,
  12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13,  6,  7, 14, 21, 28,
  35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
  58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

/* ---- errors ---------------------------------------------------------- */
typedef struct {
  jmp_buf jb;
  char *msg;
  int msg_len;
} Err;

static void fail(Err *e, int code, const char *fmt, ...) {
  if (e->msg && e->msg_len > 0) {
    va_list ap;
    va_start(ap, fmt);
    vsnprintf(e->msg, (size_t)e->msg_len, fmt, ap);
    va_end(ap);
  }
  longjmp(e->jb, code);
}

/* ---- the islow DCT pair (jfdctint.c, jidctint.c) --------------------- */
#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 2446
#define FIX_0_390180644 3196
#define FIX_0_541196100 4433
#define FIX_0_765366865 6270
#define FIX_0_899976223 7373
#define FIX_1_175875602 9633
#define FIX_1_501321110 12299
#define FIX_1_847759065 15137
#define FIX_1_961570560 16069
#define FIX_2_053119869 16819
#define FIX_2_562915447 20995
#define FIX_3_072711026 25172
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))
#define LSHIFT(x, n) ((x) * ((int64_t)1 << (n)))

/* the post-IDCT range limit: libjpeg's table read at (x & 1023), x the
   IDCT's output centred on 0 */
static uint8_t idct_limit[1024];

static void init_idct_limit(void) {
  for (int i = 0; i < 1024; i++) {
    int v;
    if (i < 128) v = i + 128;
    else if (i < 512) v = 255;
    else if (i < 896) v = 0;
    else v = i - 896;
    idct_limit[i] = (uint8_t)v;
  }
}

/* one block: dequantize, inverse DCT, write 8x8 samples at out (stride) */
static void idct_islow(const int16_t *coef, const uint16_t *q, uint8_t *out,
                       int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t *in = coef + c;
    const uint16_t *qp = q + c;
    int *w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (int)LSHIFT((int64_t)in[0] * qp[0], PASS1_BITS);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = (int64_t)in[16] * qp[16];
    z3 = (int64_t)in[48] * qp[48];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)in[0] * qp[0];
    z3 = (int64_t)in[32] * qp[32];
    tmp0 = LSHIFT(z2 + z3, CONST_BITS);
    tmp1 = LSHIFT(z2 - z3, CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qp[56];
    tmp1 = (int64_t)in[40] * qp[40];
    tmp2 = (int64_t)in[24] * qp[24];
    tmp3 = (int64_t)in[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    w[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    w[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    w[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    w[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    w[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    w[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    w[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; r++) {
    const int *w = ws + 8 * r;
    uint8_t *o = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = idct_limit[(int)DESCALE((int64_t)w[0], PASS1_BITS + 3) &
                             1023];
      memset(o, v, 8);
      continue;
    }
    int64_t z1, z2, z3, z4, z5, tmp0, tmp1, tmp2, tmp3, tmp10, tmp11, tmp12,
        tmp13;
    z2 = w[2];
    z3 = w[6];
    z1 = (z2 + z3) * FIX_0_541196100;
    tmp2 = z1 + z3 * -FIX_1_847759065;
    tmp3 = z1 + z2 * FIX_0_765366865;
    tmp0 = LSHIFT((int64_t)w[0] + w[4], CONST_BITS);
    tmp1 = LSHIFT((int64_t)w[0] - w[4], CONST_BITS);
    tmp10 = tmp0 + tmp3;
    tmp13 = tmp0 - tmp3;
    tmp11 = tmp1 + tmp2;
    tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    z4 = tmp1 + tmp3;
    z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
#define OUT(x) idct_limit[(int)DESCALE(x, CONST_BITS + PASS1_BITS + 3) & 1023]
    o[0] = OUT(tmp10 + tmp3);
    o[7] = OUT(tmp10 - tmp3);
    o[1] = OUT(tmp11 + tmp2);
    o[6] = OUT(tmp11 - tmp2);
    o[2] = OUT(tmp12 + tmp1);
    o[5] = OUT(tmp12 - tmp1);
    o[3] = OUT(tmp13 + tmp0);
    o[4] = OUT(tmp13 - tmp0);
#undef OUT
  }
}

/* one block of samples centred on 0 -> the DCT scaled by 8, in place */
static void fdct_islow(int16_t *data) {
  int64_t tmp0, tmp1, tmp2, tmp3, tmp4, tmp5, tmp6, tmp7;
  int64_t tmp10, tmp11, tmp12, tmp13, z1, z2, z3, z4, z5;
  for (int pass = 0; pass < 2; pass++) {
    int step = pass ? 8 : 1;     /* element step inside a row / column */
    int next = pass ? 1 : 8;     /* step to the next row / column */
    for (int c = 0; c < 8; c++) {
      int16_t *d = data + c * next;
      tmp0 = d[0] + d[7 * step];
      tmp7 = d[0] - d[7 * step];
      tmp1 = d[step] + d[6 * step];
      tmp6 = d[step] - d[6 * step];
      tmp2 = d[2 * step] + d[5 * step];
      tmp5 = d[2 * step] - d[5 * step];
      tmp3 = d[3 * step] + d[4 * step];
      tmp4 = d[3 * step] - d[4 * step];
      tmp10 = tmp0 + tmp3;
      tmp13 = tmp0 - tmp3;
      tmp11 = tmp1 + tmp2;
      tmp12 = tmp1 - tmp2;
      int sh = pass ? CONST_BITS + PASS1_BITS : CONST_BITS - PASS1_BITS;
      if (pass) {
        d[0] = (int16_t)DESCALE(tmp10 + tmp11, PASS1_BITS);
        d[4 * step] = (int16_t)DESCALE(tmp10 - tmp11, PASS1_BITS);
      } else {
        d[0] = (int16_t)LSHIFT(tmp10 + tmp11, PASS1_BITS);
        d[4 * step] = (int16_t)LSHIFT(tmp10 - tmp11, PASS1_BITS);
      }
      z1 = (tmp12 + tmp13) * FIX_0_541196100;
      d[2 * step] = (int16_t)DESCALE(z1 + tmp13 * FIX_0_765366865, sh);
      d[6 * step] = (int16_t)DESCALE(z1 + tmp12 * -FIX_1_847759065, sh);
      z1 = tmp4 + tmp7;
      z2 = tmp5 + tmp6;
      z3 = tmp4 + tmp6;
      z4 = tmp5 + tmp7;
      z5 = (z3 + z4) * FIX_1_175875602;
      tmp4 = tmp4 * FIX_0_298631336;
      tmp5 = tmp5 * FIX_2_053119869;
      tmp6 = tmp6 * FIX_3_072711026;
      tmp7 = tmp7 * FIX_1_501321110;
      z1 = z1 * -FIX_0_899976223;
      z2 = z2 * -FIX_2_562915447;
      z3 = z3 * -FIX_1_961570560;
      z4 = z4 * -FIX_0_390180644;
      z3 += z5;
      z4 += z5;
      d[7 * step] = (int16_t)DESCALE(tmp4 + z1 + z3, sh);
      d[5 * step] = (int16_t)DESCALE(tmp5 + z2 + z4, sh);
      d[3 * step] = (int16_t)DESCALE(tmp6 + z2 + z3, sh);
      d[step] = (int16_t)DESCALE(tmp7 + z1 + z4, sh);
    }
  }
}

/* ---- Huffman tables -------------------------------------------------- */
#define LOOK 9
typedef struct {
  int defined;
  uint8_t bits[17];          /* codes of each length 1..16 */
  uint8_t vals[256];
  int nvals;
  int32_t maxcode[18];       /* largest code of each length, -1 for none */
  int32_t valoffset[18];
  uint8_t look_len[1 << LOOK];   /* 0: the code is longer than LOOK */
  uint8_t look_sym[1 << LOOK];
  /* encoding: each symbol's code and length */
  uint16_t code[256];
  uint8_t size[256];
} Huff;

/* jdhuff.c's jpeg_make_d_derived_tbl, with its checks; 0 or an error */
static const char *huff_build(Huff *h, int is_dc) {
  int huffsize[257], huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int n = h->bits[l];
    if (p + n > 256) return "bad Huffman table (over 256 codes)";
    while (n--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  h->nvals = p;
  int code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if ((int64_t)code >= ((int64_t)1 << si))
      return "bad Huffman table (code space overflow)";
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (h->bits[l]) {
      h->valoffset[l] = p - huffcode[p];
      p += h->bits[l];
      h->maxcode[l] = huffcode[p - 1];
    } else {
      h->maxcode[l] = -1;
    }
  }
  h->maxcode[17] = 0xFFFFF;
  h->valoffset[17] = 0;
  memset(h->look_len, 0, sizeof h->look_len);
  memset(h->size, 0, sizeof h->size);
  p = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < h->bits[l]; i++, p++) {
      if (l <= LOOK) {
        int lo = huffcode[p] << (LOOK - l);
        for (int k = 0; k < (1 << (LOOK - l)); k++) {
          h->look_len[lo + k] = (uint8_t)l;
          h->look_sym[lo + k] = h->vals[p];
        }
      }
      h->code[h->vals[p]] = (uint16_t)huffcode[p];
      h->size[h->vals[p]] = (uint8_t)l;
    }
  }
  if (is_dc)
    for (int i = 0; i < h->nvals; i++)
      if (h->vals[i] > 15) return "bad Huffman table (DC symbol above 15)";
  h->defined = 1;
  return 0;
}

/* ---- the entropy-coded bit stream ------------------------------------ */
typedef struct {
  const uint8_t *data;
  size_t pos, size;
  uint64_t acc;     /* the low `bits` bits are unread, MSB first */
  int bits;
  int pad;          /* zero bits appended past the segment's end */
  int hit;          /* a marker, or the end of the data, was reached */
  size_t marker_pos;
} Bits;

static void bits_fill(Bits *b) {
  while (b->bits <= 56) {
    uint64_t c = 0;
    if (b->hit) {
      b->pad += 8;
    } else if (b->pos >= b->size) {
      b->hit = 1;
      b->marker_pos = b->size;
      b->pad += 8;
    } else {
      c = b->data[b->pos];
      if (c == 0xFF) {
        size_t p = b->pos + 1;
        while (p < b->size && b->data[p] == 0xFF) p++;
        if (p < b->size && b->data[p] == 0x00) {
          b->pos = p + 1;   /* FF 00 is a data byte FF */
        } else {            /* a marker ends the segment */
          b->hit = 1;
          b->marker_pos = b->pos;
          c = 0;
          b->pad += 8;
        }
      } else {
        b->pos++;
      }
    }
    b->acc = (b->acc << 8) | c;
    b->bits += 8;
  }
}

static inline int bits_get(Bits *b, int n) {
  if (n == 0) return 0;
  if (b->bits < n) bits_fill(b);
  b->bits -= n;
  return (int)((b->acc >> b->bits) & ((1u << n) - 1));
}

static inline int huff_decode(Bits *b, const Huff *h, Err *e) {
  if (b->bits < 16) bits_fill(b);
  unsigned look = (unsigned)(b->acc >> (b->bits - LOOK)) & ((1u << LOOK) - 1);
  int len = h->look_len[look];
  if (len) {
    b->bits -= len;
    return h->look_sym[look];
  }
  int l = LOOK + 1;
  int32_t code = (int32_t)((b->acc >> (b->bits - l)) & ((1u << l) - 1));
  while (code > h->maxcode[l]) {
    l++;
    if (l > 16) fail(e, CODEC_CORRUPT, "corrupt JPEG data: bad Huffman code");
    code = (int32_t)((b->acc >> (b->bits - l)) & ((1u << l) - 1));
  }
  b->bits -= l;
  return h->vals[(code + h->valoffset[l]) & 0xFF];
}

static inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

/* ---- the decoder ----------------------------------------------------- */
typedef struct {
  int id, h, v, tq;
  int dc, ac;                 /* tables of the current scan */
  int dw, dh;                 /* downsampled width and height */
  int wib, hib;               /* blocks holding the component's samples */
  int bw, bh;                 /* blocks allocated (MCU padding included) */
  int16_t *coef;
  uint16_t q[64];             /* quantization table latched at first scan */
  int latched;
  int scanned;
} Comp;

typedef struct {
  Err e;
  const uint8_t *data;
  size_t size, pos;
  int width, height, ncomp, frame;
  int max_h, max_v, mcus_x, mcus_y;
  Comp comp[3];
  uint16_t qt[4][64];
  int qt_defined[4];
  Huff dc[4], ac[4];
  int restart_interval;
  int jfif, adobe, adobe_transform, orientation;
  int want_h, want_w;          /* the caller's output size */
  uint8_t *planes[3];
  uint8_t *rows;
} Dec;

static int rd8(Dec *d) {
  if (d->pos >= d->size) fail(&d->e, CODEC_CORRUPT, "truncated JPEG file");
  return d->data[d->pos++];
}

static int rd16(Dec *d) {
  int hi = rd8(d);
  return (hi << 8) | rd8(d);
}

/* the segment at pos: its length (2 bytes) read, its body's [start, end) */
static size_t segment(Dec *d, size_t *end) {
  int len = rd16(d);
  if (len < 2 || d->pos - 2 + (size_t)len > d->size)
    fail(&d->e, CODEC_CORRUPT, "truncated JPEG file (segment length %d)",
         len);
  *end = d->pos - 2 + (size_t)len;
  return d->pos;
}

static void parse_dqt(Dec *d) {
  size_t end, start = segment(d, &end);
  (void)start;
  while (d->pos < end) {
    int pq = rd8(d);
    int n = pq & 15, prec = pq >> 4;
    if (n > 3 || prec > 1) fail(&d->e, CODEC_CORRUPT, "bad DQT table %d", pq);
    for (int i = 0; i < 64; i++) {
      int v = prec ? rd16(d) : rd8(d);
      d->qt[n][ZZ[i]] = (uint16_t)v;
    }
    d->qt_defined[n] = 1;
  }
  if (d->pos != end) fail(&d->e, CODEC_CORRUPT, "bad DQT length");
}

static void parse_dht(Dec *d) {
  size_t end;
  segment(d, &end);
  while (d->pos < end) {
    int tc = rd8(d);
    int cls = tc >> 4, n = tc & 15;
    if (cls > 1 || n > 3) fail(&d->e, CODEC_CORRUPT, "bad DHT table %d", tc);
    Huff *h = cls ? &d->ac[n] : &d->dc[n];
    int count = 0;
    h->bits[0] = 0;
    for (int l = 1; l <= 16; l++) {
      h->bits[l] = (uint8_t)rd8(d);
      count += h->bits[l];
    }
    if (count > 256 || d->pos + (size_t)count > end)
      fail(&d->e, CODEC_CORRUPT, "bad DHT table (%d symbols)", count);
    for (int i = 0; i < count; i++) h->vals[i] = (uint8_t)rd8(d);
    const char *err = huff_build(h, cls == 0);
    if (err) fail(&d->e, CODEC_CORRUPT, "%s", err);
  }
  if (d->pos != end) fail(&d->e, CODEC_CORRUPT, "bad DHT length");
}

/* APP1 Exif: the orientation tag (0x0112) of IFD0, else 1 */
static int exif_orientation(const uint8_t *p, size_t n) {
  if (n < 14 || memcmp(p, "Exif\0\0", 6) != 0) return 1;
  const uint8_t *t = p + 6;
  size_t tn = n - 6;
  int le;
  if (t[0] == 'I' && t[1] == 'I') le = 1;
  else if (t[0] == 'M' && t[1] == 'M') le = 0;
  else return 1;
#define U16(q) (le ? (q)[0] | ((q)[1] << 8) : ((q)[0] << 8) | (q)[1])
#define U32(q) (le ? (uint32_t)(q)[0] | ((uint32_t)(q)[1] << 8) |          \
                     ((uint32_t)(q)[2] << 16) | ((uint32_t)(q)[3] << 24)   \
                   : ((uint32_t)(q)[0] << 24) | ((uint32_t)(q)[1] << 16) | \
                     ((uint32_t)(q)[2] << 8) | (uint32_t)(q)[3])
  uint32_t ifd = U32(t + 4);
  if ((size_t)ifd + 2 > tn) return 1;
  int entries = U16(t + ifd);
  for (int i = 0; i < entries; i++) {
    size_t at = (size_t)ifd + 2 + 12 * (size_t)i;
    if (at + 12 > tn) return 1;
    if (U16(t + at) == 0x0112) {
      int type = U16(t + at + 2);
      if (type != 3) return 1;
      return U16(t + at + 8);
    }
  }
  return 1;
#undef U16
#undef U32
}

static void parse_app(Dec *d, int marker) {
  size_t end, start = segment(d, &end);
  size_t n = end - start;
  const uint8_t *p = d->data + start;
  if (marker == 0xE0 && n >= 14 && memcmp(p, "JFIF\0", 5) == 0) d->jfif = 1;
  if (marker == 0xE1 && d->orientation == 1) {
    d->orientation = exif_orientation(p, n);
  }
  if (marker == 0xEE && n >= 12 && memcmp(p, "Adobe", 5) == 0) {
    d->adobe = 1;
    d->adobe_transform = p[11];
  }
  d->pos = end;
}

static void parse_sof(Dec *d, int marker) {
  size_t end;
  segment(d, &end);
  if (d->frame) fail(&d->e, CODEC_CORRUPT, "two frame headers");
  int precision = rd8(d);
  d->height = rd16(d);
  d->width = rd16(d);
  d->ncomp = rd8(d);
  if (precision != 8)
    fail(&d->e, CODEC_UNSUPPORTED, "%d-bit JPEG (SOF%d)", precision,
         marker - 0xC0);
  if (d->height == 0)
    fail(&d->e, CODEC_UNSUPPORTED, "JPEG whose height is set by DNL");
  if (d->width == 0) fail(&d->e, CODEC_CORRUPT, "JPEG of width 0");
  if (d->ncomp == 4)
    fail(&d->e, CODEC_UNSUPPORTED, "4-component (CMYK or YCCK) JPEG");
  if (d->ncomp != 1 && d->ncomp != 3)
    fail(&d->e, CODEC_UNSUPPORTED, "JPEG of %d components", d->ncomp);
  if ((size_t)8 + 3 * (size_t)d->ncomp != end - d->pos + 8)
    fail(&d->e, CODEC_CORRUPT, "bad SOF length");
  if ((int64_t)d->width * d->height > ((int64_t)1 << 30))
    fail(&d->e, CODEC_CORRUPT, "JPEG of %dx%d pixels is too large",
         d->width, d->height);
  d->max_h = d->max_v = 1;
  for (int c = 0; c < d->ncomp; c++) {
    Comp *k = &d->comp[c];
    k->id = rd8(d);
    int hv = rd8(d);
    k->h = hv >> 4;
    k->v = hv & 15;
    k->tq = rd8(d);
    if (k->h < 1 || k->h > 4 || k->v < 1 || k->v > 4 || k->tq > 3)
      fail(&d->e, CODEC_CORRUPT, "bad component %d in SOF", c);
    if (k->h > 2 || k->v > 2)
      fail(&d->e, CODEC_UNSUPPORTED, "JPEG sampling factor %dx%d (above 2)",
           k->h, k->v);
    if (k->h > d->max_h) d->max_h = k->h;
    if (k->v > d->max_v) d->max_v = k->v;
  }
  d->mcus_x = (d->width + 8 * d->max_h - 1) / (8 * d->max_h);
  d->mcus_y = (d->height + 8 * d->max_v - 1) / (8 * d->max_v);
  for (int c = 0; c < d->ncomp; c++) {
    Comp *k = &d->comp[c];
    k->dw = (int)(((int64_t)d->width * k->h + d->max_h - 1) / d->max_h);
    k->dh = (int)(((int64_t)d->height * k->v + d->max_v - 1) / d->max_v);
    k->wib = (k->dw + 7) / 8;
    k->hib = (k->dh + 7) / 8;
    k->bw = d->mcus_x * k->h;
    k->bh = d->mcus_y * k->v;
    k->coef = (int16_t *)calloc((size_t)k->bw * k->bh * 64, sizeof(int16_t));
    if (!k->coef) fail(&d->e, CODEC_NOMEM, "out of memory");
  }
  d->pos = end;
  d->frame = 1;
}

static void decode_block(Dec *d, Bits *b, int16_t *blk, const Huff *dc,
                         const Huff *ac, int *last_dc) {
  int s = huff_decode(b, dc, &d->e);
  int diff = s ? extend(bits_get(b, s), s) : 0;
  *last_dc += diff;
  blk[0] = (int16_t)*last_dc;
  for (int k = 1; k < 64; k++) {
    int rs = huff_decode(b, ac, &d->e);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      if (k > 63)
        fail(&d->e, CODEC_CORRUPT, "corrupt JPEG data: coefficient past 63");
      blk[ZZ[k]] = (int16_t)extend(bits_get(b, s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

/* the bit reader to the restart marker `n`, past it, reset */
static void restart(Dec *d, Bits *b, int n) {
  size_t p;
  if (b->hit) {
    p = b->marker_pos;
  } else {
    p = b->pos;
  }
  if (p + 1 >= d->size || d->data[p] != 0xFF)
    fail(&d->e, CODEC_CORRUPT, "corrupt JPEG data: restart marker missing");
  while (p < d->size && d->data[p] == 0xFF) p++;
  if (p >= d->size || d->data[p] != 0xD0 + (n & 7))
    fail(&d->e, CODEC_CORRUPT, "corrupt JPEG data: restart marker %d missing",
         n & 7);
  b->pos = p + 1;
  b->acc = 0;
  b->bits = 0;
  b->pad = 0;
  b->hit = 0;
}

static void parse_sos(Dec *d) {
  size_t end;
  segment(d, &end);
  if (!d->frame) fail(&d->e, CODEC_CORRUPT, "scan before the frame header");
  int ns = rd8(d);
  if (ns < 1 || ns > d->ncomp || end - d->pos != (size_t)(2 * ns + 3))
    fail(&d->e, CODEC_CORRUPT, "bad SOS header");
  Comp *scan[3];
  for (int i = 0; i < ns; i++) {
    int id = rd8(d), t = rd8(d);
    Comp *k = 0;
    for (int c = 0; c < d->ncomp; c++)
      if (d->comp[c].id == id) k = &d->comp[c];
    for (int j = 0; j < i; j++)
      if (scan[j] == k) k = 0;
    if (!k) fail(&d->e, CODEC_CORRUPT, "bad component %d in SOS", id);
    k->dc = t >> 4;
    k->ac = t & 15;
    if (k->dc > 3 || k->ac > 3 || !d->dc[k->dc].defined ||
        !d->ac[k->ac].defined)
      fail(&d->e, CODEC_CORRUPT, "scan uses an undefined Huffman table");
    if (!k->latched) {
      if (!d->qt_defined[k->tq])
        fail(&d->e, CODEC_CORRUPT, "undefined quantization table %d", k->tq);
      memcpy(k->q, d->qt[k->tq], sizeof k->q);
      k->latched = 1;
    }
    k->scanned = 1;
    scan[i] = k;
  }
  d->pos = end;   /* Ss, Se, Ah/Al: baseline ignores them */
  int blocks_in_mcu = 0;
  for (int i = 0; i < ns; i++) blocks_in_mcu += scan[i]->h * scan[i]->v;
  if (ns > 1 && blocks_in_mcu > 10)
    fail(&d->e, CODEC_CORRUPT, "sampling factors too large for an "
         "interleaved scan");

  Bits b = {d->data, d->pos, d->size, 0, 0, 0, 0, 0};
  int last[3] = {0, 0, 0};
  int mx = ns > 1 ? d->mcus_x : scan[0]->wib;
  int my = ns > 1 ? d->mcus_y : scan[0]->hib;
  int64_t total = (int64_t)mx * my, todo = d->restart_interval;
  int rst = 0;
  for (int64_t m = 0; m < total; m++) {
    if (d->restart_interval) {
      if (todo == 0) {
        if (b.bits < b.pad)
          fail(&d->e, CODEC_CORRUPT, "truncated JPEG data");
        restart(d, &b, rst++);
        last[0] = last[1] = last[2] = 0;
        todo = d->restart_interval;
      }
      todo--;
    }
    int x = (int)(m % mx), y = (int)(m / mx);
    for (int i = 0; i < ns; i++) {
      Comp *k = scan[i];
      int hs = ns > 1 ? k->h : 1, vs = ns > 1 ? k->v : 1;
      for (int by = 0; by < vs; by++)
        for (int bx = 0; bx < hs; bx++) {
          int row = y * vs + by, col = x * hs + bx;
          int16_t *blk = k->coef + ((size_t)row * k->bw + col) * 64;
          decode_block(d, &b, blk, &d->dc[k->dc], &d->ac[k->ac], &last[i]);
        }
    }
    if (b.bits < b.pad) fail(&d->e, CODEC_CORRUPT, "truncated JPEG data");
  }
  /* on to the next marker: past whatever is left of the segment */
  size_t p = b.hit ? b.marker_pos : b.pos;
  while (p + 1 < d->size && !(d->data[p] == 0xFF && d->data[p + 1] != 0 &&
                              d->data[p + 1] != 0xFF))
    p++;
  d->pos = p + 1 < d->size ? p : d->size;
}

/* one component's samples, planes of bw*8 x bh*8 */
static void idct_component(Dec *d, int c) {
  Comp *k = &d->comp[c];
  size_t stride = (size_t)k->bw * 8;
  uint8_t *plane = (uint8_t *)malloc(stride * (size_t)k->bh * 8);
  if (!plane) fail(&d->e, CODEC_NOMEM, "out of memory");
  d->planes[c] = plane;
  int rows = (k->dh + 7) / 8, cols = (k->dw + 7) / 8;
  for (int by = 0; by < rows; by++)
    for (int bx = 0; bx < cols; bx++)
      idct_islow(k->coef + ((size_t)by * k->bw + bx) * 64, k->q,
                 plane + (size_t)by * 8 * stride + (size_t)bx * 8,
                 (int)stride);
}

/* jdsample.c: output row y of component c at full resolution into out
   (at least 2 * dw + 1 samples) */
static void upsample_row(Dec *d, int c, int y, uint8_t *out) {
  Comp *k = &d->comp[c];
  int rh = d->max_h / k->h, rv = d->max_v / k->v;
  size_t stride = (size_t)k->bw * 8;
  const uint8_t *plane = d->planes[c];
  int dw = k->dw, dh = k->dh;
  if (rh == 1 && rv == 1) {
    memcpy(out, plane + (size_t)y * stride, (size_t)dw);
    return;
  }
  if (rv == 1) {                       /* h2v1 */
    const uint8_t *in = plane + (size_t)y * stride;
    if (dw > 2) {
      out[0] = in[0];
      out[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
      for (int i = 1; i < dw - 1; i++) {
        int v = in[i] * 3;
        out[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
        out[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
      }
      out[2 * dw - 2] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
      out[2 * dw - 1] = in[dw - 1];
    } else {
      for (int i = 0; i < dw; i++) out[2 * i] = out[2 * i + 1] = in[i];
    }
    return;
  }
  int iy = y >> 1, below = y & 1;
  const uint8_t *in0 = plane + (size_t)iy * stride;
  int ny = below ? (iy + 1 < dh ? iy + 1 : dh - 1) : (iy > 0 ? iy - 1 : 0);
  const uint8_t *in1 = plane + (size_t)ny * stride;
  if (rh == 1) {                       /* h1v2, always fancy */
    int bias = below ? 2 : 1;
    for (int i = 0; i < dw; i++)
      out[i] = (uint8_t)((in0[i] * 3 + in1[i] + bias) >> 2);
    return;
  }
  if (dw > 2) {                        /* h2v2 fancy */
    int this_sum = in0[0] * 3 + in1[0];
    int next_sum = in0[1] * 3 + in1[1];
    int last_sum;
    out[0] = (uint8_t)((this_sum * 4 + 8) >> 4);
    out[1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
    last_sum = this_sum;
    this_sum = next_sum;
    for (int i = 1; i < dw - 1; i++) {
      next_sum = in0[i + 1] * 3 + in1[i + 1];
      out[2 * i] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      out[2 * i + 1] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      last_sum = this_sum;
      this_sum = next_sum;
    }
    out[2 * dw - 2] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
    out[2 * dw - 1] = (uint8_t)((this_sum * 4 + 7) >> 4);
  } else {                             /* h2v2 by replication */
    for (int i = 0; i < dw; i++) out[2 * i] = out[2 * i + 1] = in0[i];
  }
}

/* jdcolor.c's tables */
static int cr_r[256], cb_b[256];
static int64_t cr_g[256], cb_g[256];

static void init_color_tables(void) {
  const int64_t half = (int64_t)1 << 15;
  for (int i = 0; i < 256; i++) {
    int64_t x = i - 128;
    cr_r[i] = (int)((91881 * x + half) >> 16);      /* FIX(1.40200) */
    cb_b[i] = (int)((116130 * x + half) >> 16);     /* FIX(1.77200) */
    cr_g[i] = -46802 * x;                           /* FIX(0.71414) */
    cb_g[i] = -22554 * x + half;                    /* FIX(0.34414) */
  }
}

static inline uint8_t clamp255(int v) {
  return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

static void init_rgb_ycc(void);

/* every table is built once, when the library is loaded, so that threads
   may call in at once */
__attribute__((constructor)) static void init_tables(void) {
  init_idct_limit();
  init_color_tables();
  init_rgb_ycc();
}

static void dec_free(Dec *d) {
  for (int c = 0; c < 3; c++) {
    free(d->comp[c].coef);
    free(d->planes[c]);
  }
  free(d->rows);
  free(d);
}

/* parse markers up to the frame header (out == NULL) or decode the whole
   image into out (BGR, height x width x 3) */
static int jpeg_run(Dec *d, uint8_t *out) {
  if (d->size < 2 || d->data[0] != 0xFF || d->data[1] != 0xD8)
    fail(&d->e, CODEC_CORRUPT, "not a JPEG file (no SOI marker)");
  d->pos = 2;
  d->orientation = 1;
  int ended = 0;
  while (!ended) {
    if (d->pos >= d->size) {
      int complete = d->frame;
      for (int c = 0; c < d->ncomp; c++) complete &= d->comp[c].scanned;
      if (complete && out) break;     /* EOI missing after the last scan */
      fail(&d->e, CODEC_CORRUPT, "truncated JPEG file");
    }
    if (rd8(d) != 0xFF)
      fail(&d->e, CODEC_CORRUPT, "corrupt JPEG data: a marker expected at "
           "byte %zu", d->pos - 1);
    int m = rd8(d);
    while (m == 0xFF) m = rd8(d);
    switch (m) {
      case 0xC0:
      case 0xC1:
        parse_sof(d, m);
        if (d->orientation >= 2 && d->orientation <= 8)
          fail(&d->e, CODEC_UNSUPPORTED, "JPEG with EXIF orientation %d",
               d->orientation);
        if (!out) return CODEC_OK;
        if (d->height != d->want_h || d->width != d->want_w)
          fail(&d->e, CODEC_CORRUPT, "JPEG of %dx%d, not the %dx%d asked "
               "for", d->height, d->width, d->want_h, d->want_w);
        break;
      case 0xC2:
        fail(&d->e, CODEC_UNSUPPORTED, "progressive JPEG (SOF2)");
        break;
      case 0xC3: case 0xC5: case 0xC6: case 0xC7:
        fail(&d->e, CODEC_UNSUPPORTED, "lossless or hierarchical JPEG "
             "(SOF%d)", m - 0xC0);
        break;
      case 0xC9: case 0xCA: case 0xCB: case 0xCC: case 0xCD: case 0xCE:
      case 0xCF:
        fail(&d->e, CODEC_UNSUPPORTED, "arithmetic-coded JPEG (marker "
             "0x%02X)", m);
        break;
      case 0xC4:
        parse_dht(d);
        break;
      case 0xDB:
        parse_dqt(d);
        break;
      case 0xDD: {
        size_t end;
        segment(d, &end);
        if (end - d->pos != 2) fail(&d->e, CODEC_CORRUPT, "bad DRI length");
        d->restart_interval = rd16(d);
        break;
      }
      case 0xDA:
        parse_sos(d);
        break;
      case 0xD9:
        ended = 1;
        break;
      case 0x01:
      case 0xD0: case 0xD1: case 0xD2: case 0xD3: case 0xD4: case 0xD5:
      case 0xD6: case 0xD7:
        break;               /* no length */
      case 0xD8:
        fail(&d->e, CODEC_CORRUPT, "a second SOI marker");
        break;
      default:
        if (m == 0x00)
          fail(&d->e, CODEC_CORRUPT, "corrupt JPEG data: stray FF 00");
        if (m >= 0xE0 && m <= 0xEF) {
          parse_app(d, m);
        } else {
          size_t end;
          segment(d, &end);
          d->pos = end;
        }
    }
  }
  if (!d->frame) fail(&d->e, CODEC_CORRUPT, "JPEG without a frame header");
  if (!out) return CODEC_OK;
  for (int c = 0; c < d->ncomp; c++)
    if (!d->comp[c].scanned)
      fail(&d->e, CODEC_CORRUPT, "JPEG component %d has no scan", c);

  for (int c = 0; c < d->ncomp; c++) idct_component(d, c);
  int rgb = 0;
  if (d->ncomp == 3) {
    if (d->jfif) rgb = 0;
    else if (d->adobe) rgb = d->adobe_transform == 0;
    else rgb = d->comp[0].id == 'R' && d->comp[1].id == 'G' &&
               d->comp[2].id == 'B';
  }
  size_t row_len = (size_t)d->width * 2 + 16;
  d->rows = (uint8_t *)malloc(row_len * 3);
  if (!d->rows) fail(&d->e, CODEC_NOMEM, "out of memory");
  uint8_t *r0 = d->rows, *r1 = r0 + row_len, *r2 = r1 + row_len;
  for (int y = 0; y < d->height; y++) {
    uint8_t *o = out + (size_t)y * d->width * 3;
    upsample_row(d, 0, y, r0);
    if (d->ncomp == 1) {
      for (int x = 0; x < d->width; x++) o[3 * x] = o[3 * x + 1] =
          o[3 * x + 2] = r0[x];
      continue;
    }
    upsample_row(d, 1, y, r1);
    upsample_row(d, 2, y, r2);
    if (rgb) {
      for (int x = 0; x < d->width; x++) {
        o[3 * x] = r2[x];
        o[3 * x + 1] = r1[x];
        o[3 * x + 2] = r0[x];
      }
      continue;
    }
    for (int x = 0; x < d->width; x++) {
      int yy = r0[x], cb = r1[x], cr = r2[x];
      o[3 * x] = clamp255(yy + cb_b[cb]);
      o[3 * x + 1] = clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + cr_r[cr]);
    }
  }
  return CODEC_OK;
}

static Dec *dec_new(const uint8_t *data, size_t size, char *msg,
                    int msg_len) {
  Dec *d = (Dec *)calloc(1, sizeof(Dec));
  if (d) {
    d->e.msg = msg;
    d->e.msg_len = msg_len;
    d->data = data;
    d->size = size;
  }
  return d;
}

/* the size of a JPEG: dims gets its height and width */
int jpeg_info(const uint8_t *data, size_t size, int *dims, char *msg,
              int msg_len) {
  Dec *d = dec_new(data, size, msg, msg_len);
  if (!d) return CODEC_NOMEM;
  int rc = setjmp(d->e.jb);
  if (rc == 0) {
    rc = jpeg_run(d, 0);
    dims[0] = d->height;
    dims[1] = d->width;
  }
  dec_free(d);
  return rc;
}

/* decode into out: BGR uint8, height x width x 3 (jpeg_info's size) */
int jpeg_decode(const uint8_t *data, size_t size, uint8_t *out, int height,
                int width, char *msg, int msg_len) {
  Dec *d = dec_new(data, size, msg, msg_len);
  if (!d) return CODEC_NOMEM;
  d->want_h = height;
  d->want_w = width;
  int rc = setjmp(d->e.jb);
  if (rc == 0) rc = jpeg_run(d, out);
  dec_free(d);
  return rc;
}

/* ---- the encoder ----------------------------------------------------- */
static const uint8_t STD_LUMA_Q[64] = {
  16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
  14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
  18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
  49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
static const uint8_t STD_CHROMA_Q[64] = {
  17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
  24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
  99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
  99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

static const uint8_t DC_LUMA_BITS[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1,
                                         0, 0, 0, 0, 0, 0, 0};
static const uint8_t DC_CHROMA_BITS[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1,
                                           1, 1, 0, 0, 0, 0, 0};
static const uint8_t DC_VALS[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
static const uint8_t AC_LUMA_BITS[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                         5, 5, 4, 4, 0, 0, 1, 0x7d};
static const uint8_t AC_LUMA_VALS[162] = {
  0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
  0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
  0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
  0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
  0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
  0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
  0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
  0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
  0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
  0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
  0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
  0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
  0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
  0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
static const uint8_t AC_CHROMA_BITS[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                           7, 5, 4, 4, 0, 1, 2, 0x77};
static const uint8_t AC_CHROMA_VALS[162] = {
  0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
  0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
  0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
  0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
  0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
  0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
  0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
  0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
  0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
  0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
  0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
  0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
  0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
  0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

typedef struct {
  Err e;
  uint8_t *out;
  size_t cap, len;
  uint64_t acc;     /* pending bits, the low `bits` of them */
  int bits;
  uint8_t *buf[5];  /* Y, Cb, Cr at full size; Cb, Cr downsampled */
  Huff hs[4];       /* DC and AC, luma then chroma */
} Enc;

/* jccolor.c's rgb_ycc tables: R, G, B to Y; R, G, B to Cb (B to Cb is
   also R to Cr); G, B to Cr */
static int64_t rgb_ycc[8 * 256];

static void init_rgb_ycc(void) {
  const int64_t half = (int64_t)1 << 15, off = (int64_t)128 << 16;
  for (int i = 0; i < 256; i++) {
    rgb_ycc[i] = 19595 * (int64_t)i;                     /* FIX(0.29900) */
    rgb_ycc[256 + i] = 38470 * (int64_t)i;               /* FIX(0.58700) */
    rgb_ycc[512 + i] = 7471 * (int64_t)i + half;         /* FIX(0.11400) */
    rgb_ycc[768 + i] = -11059 * (int64_t)i;              /* FIX(0.16874) */
    rgb_ycc[1024 + i] = -21709 * (int64_t)i;             /* FIX(0.33126) */
    rgb_ycc[1280 + i] = 32768 * (int64_t)i + off + half - 1;
    rgb_ycc[1536 + i] = -27439 * (int64_t)i;             /* FIX(0.41869) */
    rgb_ycc[1792 + i] = -5329 * (int64_t)i;              /* FIX(0.08131) */
  }
}

static inline void put_byte(Enc *w, int v) {
  if (w->len >= w->cap) fail(&w->e, CODEC_SMALL, "output buffer too small");
  w->out[w->len++] = (uint8_t)v;
}

static void put16(Enc *w, int v) {
  put_byte(w, v >> 8);
  put_byte(w, v & 0xFF);
}

static inline void put_bits(Enc *w, uint32_t code, int n) {
  w->acc = (w->acc << n) | (code & ((1u << n) - 1));
  w->bits += n;
  while (w->bits >= 8) {
    w->bits -= 8;
    int c = (int)((w->acc >> w->bits) & 0xFF);
    put_byte(w, c);
    if (c == 0xFF) put_byte(w, 0);
  }
}

/* jcdctmgr.c's compute_reciprocal with 16-bit DCT elements */
typedef struct {
  uint16_t recip[64], corr[64];
  int shift[64];    /* total right shift of the product */
} Divisors;

static void make_divisors(Divisors *dv, const uint16_t *q) {
  for (int i = 0; i < 64; i++) {
    uint32_t divisor = (uint32_t)q[i] << 3;
    int b = 31 - __builtin_clz(divisor);
    int r = 16 + b;
    uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
    uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
    uint32_t c = divisor / 2;
    if (fr == 0) {
      fq >>= 1;
      r--;
    } else if (fr <= divisor / 2u) {
      c++;
    } else {
      fq++;
    }
    dv->recip[i] = (uint16_t)fq;
    dv->corr[i] = (uint16_t)c;
    dv->shift[i] = r;
  }
}

static void quantize(const int16_t *ws, const Divisors *dv, int16_t *coef) {
  for (int i = 0; i < 64; i++) {
    int t = ws[i];
    uint32_t a = (uint32_t)(t < 0 ? -t : t);
    uint32_t p = ((a + dv->corr[i]) * (uint32_t)dv->recip[i]) >>
                 dv->shift[i];
    coef[i] = (int16_t)(t < 0 ? -(int)(uint16_t)p : (int)(uint16_t)p);
  }
}

static void encode_block(Enc *w, const int16_t *coef, int *last_dc,
                         const Huff *dc, const Huff *ac) {
  int temp = coef[0] - *last_dc, temp2 = temp;
  *last_dc = coef[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = temp ? 32 - __builtin_clz((unsigned)temp) : 0;
  put_bits(w, dc->code[nbits], dc->size[nbits]);
  if (nbits) put_bits(w, (uint32_t)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = coef[ZZ[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      put_bits(w, ac->code[0xF0], ac->size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 32 - __builtin_clz((unsigned)temp);
    int sym = (r << 4) + nbits;
    put_bits(w, ac->code[sym], ac->size[sym]);
    put_bits(w, (uint32_t)temp2, nbits);
    r = 0;
  }
  if (r > 0) put_bits(w, ac->code[0], ac->size[0]);
}

static void std_huff(Huff *h, const uint8_t *bits, const uint8_t *vals,
                     int n, int is_dc) {
  memset(h, 0, sizeof *h);
  memcpy(h->bits, bits, 17);
  memcpy(h->vals, vals, (size_t)n);
  huff_build(h, is_dc);
}

static void put_dht(Enc *w, int tc, const uint8_t *bits, const uint8_t *vals,
                    int n) {
  put_byte(w, 0xFF);
  put_byte(w, 0xC4);
  put16(w, 2 + 1 + 16 + n);
  put_byte(w, tc);
  for (int l = 1; l <= 16; l++) put_byte(w, bits[l]);
  for (int i = 0; i < n; i++) put_byte(w, vals[i]);
}

/* the 8x8 block at (x0, y0) of a plane, centred on 0 */
static void block_of(const uint8_t *plane, size_t stride, int x0, int y0,
                     int16_t *ws) {
  for (int r = 0; r < 8; r++) {
    const uint8_t *p = plane + (size_t)(y0 + r) * stride + x0;
    for (int c = 0; c < 8; c++) ws[8 * r + c] = (int16_t)(p[c] - 128);
  }
}

static uint8_t *enc_alloc(Enc *w, int i, size_t n) {
  w->buf[i] = (uint8_t *)malloc(n);
  if (!w->buf[i]) fail(&w->e, CODEC_NOMEM, "out of memory");
  return w->buf[i];
}

static void dct_quantize(const uint8_t *plane, size_t stride, int x0, int y0,
                         const Divisors *dv, int16_t *coef) {
  int16_t ws[64];
  block_of(plane, stride, x0, y0, ws);
  fdct_islow(ws);
  quantize(ws, dv, coef);
}

/* gray: one component, its blocks in raster order; the plane padded to
   whole blocks by replicating its last column and its last row */
static void encode_gray(Enc *w, const uint8_t *pixels, int height, int width,
                        const Divisors *dv) {
  int bw = (width + 7) / 8, bh = (height + 7) / 8;
  size_t stride = (size_t)bw * 8;
  uint8_t *plane = enc_alloc(w, 0, stride * (size_t)bh * 8);
  for (int y = 0; y < bh * 8; y++) {
    const uint8_t *src =
        pixels + (size_t)(y < height ? y : height - 1) * width;
    uint8_t *dst = plane + (size_t)y * stride;
    memcpy(dst, src, (size_t)width);
    memset(dst + width, src[width - 1], stride - (size_t)width);
  }
  int16_t coef[64];
  int last = 0;
  for (int by = 0; by < bh; by++)
    for (int bx = 0; bx < bw; bx++) {
      dct_quantize(plane, stride, bx * 8, by * 8, dv, coef);
      encode_block(w, coef, &last, &w->hs[0], &w->hs[1]);
    }
}

/* BGR at 4:2:0 (cv2's default): MCUs of 16x16 pixels, 4 Y blocks and one
   each of Cb and Cr. The full-size planes are padded to the MCU grid's
   width by replicating their last column. Y's rows past the image repeat
   its last row; Cb and Cr are averaged over 2x2 pixels with the bias 1,
   2, 1, 2, ... along a row (a missing odd row is the last row again), and
   their rows past ceil(height / 2) repeat their last one (jcprepct.c's
   expand_bottom_edge of the downsampled rows). Y blocks past
   ceil(width / 8) or ceil(height / 8) are dummies (jccoefct.c): no AC, the
   DC of the block before them in the MCU. */
static void encode_420(Enc *w, const uint8_t *pixels, int height, int width,
                       const Divisors *dv) {
  int mx = (width + 15) / 16, my = (height + 15) / 16;
  size_t stride = (size_t)mx * 16;
  int rows_full = my * 16;
  uint8_t *full[3];
  for (int c = 0; c < 3; c++)
    full[c] = enc_alloc(w, c, stride * (size_t)rows_full);
  const int64_t *t = rgb_ycc;
  for (int y = 0; y < height; y++) {
    const uint8_t *src = pixels + (size_t)y * width * 3;
    uint8_t *py = full[0] + (size_t)y * stride;
    uint8_t *pb = full[1] + (size_t)y * stride;
    uint8_t *pr = full[2] + (size_t)y * stride;
    for (int x = 0; x < width; x++) {
      int b = src[3 * x], g = src[3 * x + 1], r = src[3 * x + 2];
      py[x] = (uint8_t)((t[r] + t[256 + g] + t[512 + b]) >> 16);
      pb[x] = (uint8_t)((t[768 + r] + t[1024 + g] + t[1280 + b]) >> 16);
      pr[x] = (uint8_t)((t[1280 + r] + t[1536 + g] + t[1792 + b]) >> 16);
    }
    for (int c = 0; c < 3; c++) {
      uint8_t *p = full[c] + (size_t)y * stride;
      memset(p + width, p[width - 1], stride - (size_t)width);
    }
  }
  for (int y = height; y < rows_full; y++)
    memcpy(full[0] + (size_t)y * stride,
           full[0] + (size_t)(height - 1) * stride, stride);
  int cw = mx * 8, ch = my * 8, ch_real = (height + 1) / 2;
  uint8_t *sub[2];
  for (int c = 0; c < 2; c++) {
    sub[c] = enc_alloc(w, 3 + c, (size_t)cw * ch);
    for (int y = 0; y < ch_real; y++) {
      const uint8_t *a = full[1 + c] + (size_t)(2 * y) * stride;
      const uint8_t *b =
          full[1 + c] +
          (size_t)(2 * y + 1 < height ? 2 * y + 1 : height - 1) * stride;
      uint8_t *o = sub[c] + (size_t)y * cw;
      int bias = 1;
      for (int x = 0; x < cw; x++) {
        o[x] = (uint8_t)((a[2 * x] + a[2 * x + 1] + b[2 * x] + b[2 * x + 1] +
                          bias) >> 2);
        bias ^= 3;
      }
    }
    for (int y = ch_real; y < ch; y++)
      memcpy(sub[c] + (size_t)y * cw, sub[c] + (size_t)(ch_real - 1) * cw,
             (size_t)cw);
  }
  int ybw = (width + 7) / 8, ybh = (height + 7) / 8;
  int last[3] = {0, 0, 0};
  int16_t yb[4][64], coef[64];
  for (int m_y = 0; m_y < my; m_y++)
    for (int m_x = 0; m_x < mx; m_x++) {
      for (int b = 0; b < 4; b++) {
        int bx = m_x * 2 + (b & 1), by = m_y * 2 + (b >> 1);
        if (by >= ybh || bx >= ybw) {
          memset(yb[b], 0, sizeof yb[b]);
          yb[b][0] = yb[b - 1][0];
        } else {
          dct_quantize(full[0], stride, bx * 8, by * 8, &dv[0], yb[b]);
        }
      }
      for (int b = 0; b < 4; b++)
        encode_block(w, yb[b], &last[0], &w->hs[0], &w->hs[1]);
      for (int c = 0; c < 2; c++) {
        dct_quantize(sub[c], (size_t)cw, m_x * 8, m_y * 8, &dv[1], coef);
        encode_block(w, coef, &last[1 + c], &w->hs[2], &w->hs[3]);
      }
    }
}

/* encode height x width pixels (channels 3: BGR; 1: gray) at quality
   1..100 into out (capacity cap); *written gets the byte count */
int jpeg_encode(const uint8_t *pixels, int height, int width, int channels,
                int quality, uint8_t *out, size_t cap, size_t *written,
                char *msg, int msg_len) {
  Enc *w = (Enc *)calloc(1, sizeof(Enc));
  if (!w) return CODEC_NOMEM;
  w->e.msg = msg;
  w->e.msg_len = msg_len;
  w->out = out;
  w->cap = cap;
  int rc = setjmp(w->e.jb);
  if (rc == 0) {
    if (height < 1 || width < 1 || height > 65535 || width > 65535)
      fail(&w->e, CODEC_CORRUPT, "JPEG size %dx%d out of range", height,
           width);
    if (channels != 1 && channels != 3)
      fail(&w->e, CODEC_CORRUPT, "JPEG of %d channels", channels);
    /* jcparam.c: jpeg_quality_scaling, jpeg_add_quant_table (baseline) */
    int qual = quality < 1 ? 1 : quality > 100 ? 100 : quality;
    int scale = qual < 50 ? 5000 / qual : 200 - qual * 2;
    uint16_t q[2][64];
    for (int t = 0; t < 2; t++)
      for (int i = 0; i < 64; i++) {
        long v = ((long)(t ? STD_CHROMA_Q : STD_LUMA_Q)[i] * scale + 50L) /
                 100L;
        q[t][i] = (uint16_t)(v <= 0 ? 1 : v > 255 ? 255 : v);
      }
    Divisors dv[2];
    make_divisors(&dv[0], q[0]);
    make_divisors(&dv[1], q[1]);
    std_huff(&w->hs[0], DC_LUMA_BITS, DC_VALS, 12, 1);
    std_huff(&w->hs[1], AC_LUMA_BITS, AC_LUMA_VALS, 162, 0);
    std_huff(&w->hs[2], DC_CHROMA_BITS, DC_VALS, 12, 1);
    std_huff(&w->hs[3], AC_CHROMA_BITS, AC_CHROMA_VALS, 162, 0);
    int ncomp = channels;

    /* jcmarker.c: SOI, JFIF APP0 (1.01, no density unit, 1:1), the DQTs,
       SOF0, the DHTs of the scan (DC then AC of each table), SOS */
    static const uint8_t head[20] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J',
                                     'F', 'I', 'F', 0, 1, 1, 0, 0, 1,
                                     0, 1, 0, 0};
    for (int i = 0; i < 20; i++) put_byte(w, head[i]);
    for (int t = 0; t < (ncomp == 3 ? 2 : 1); t++) {
      put_byte(w, 0xFF);
      put_byte(w, 0xDB);
      put16(w, 67);
      put_byte(w, t);
      for (int i = 0; i < 64; i++) put_byte(w, q[t][ZZ[i]]);
    }
    put_byte(w, 0xFF);
    put_byte(w, 0xC0);
    put16(w, 8 + 3 * ncomp);
    put_byte(w, 8);
    put16(w, height);
    put16(w, width);
    put_byte(w, ncomp);
    for (int c = 0; c < ncomp; c++) {
      put_byte(w, c + 1);
      put_byte(w, ncomp == 3 && c == 0 ? 0x22 : 0x11);
      put_byte(w, c ? 1 : 0);
    }
    put_dht(w, 0x00, DC_LUMA_BITS, DC_VALS, 12);
    put_dht(w, 0x10, AC_LUMA_BITS, AC_LUMA_VALS, 162);
    if (ncomp == 3) {
      put_dht(w, 0x01, DC_CHROMA_BITS, DC_VALS, 12);
      put_dht(w, 0x11, AC_CHROMA_BITS, AC_CHROMA_VALS, 162);
    }
    put_byte(w, 0xFF);
    put_byte(w, 0xDA);
    put16(w, 6 + 2 * ncomp);
    put_byte(w, ncomp);
    for (int c = 0; c < ncomp; c++) {
      put_byte(w, c + 1);
      put_byte(w, c ? 0x11 : 0x00);
    }
    put_byte(w, 0);
    put_byte(w, 63);
    put_byte(w, 0);
    if (ncomp == 1)
      encode_gray(w, pixels, height, width, &dv[0]);
    else
      encode_420(w, pixels, height, width, dv);
    /* the last byte padded with ones (jchuff.c's flush_bits), then EOI */
    if (w->bits) put_bits(w, 0x7F, 8 - w->bits);
    put_byte(w, 0xFF);
    put_byte(w, 0xD9);
    *written = w->len;
  }
  for (int i = 0; i < 5; i++) free(w->buf[i]);
  free(w);
  return rc;
}

/* ---- PNG ------------------------------------------------------------- */
static inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

/* PNG's five row filters undone (PNG spec 9.2): raw holds height rows of
   a filter-type byte and `stride` bytes, bpp bytes a pixel. Returns 0, or
   1 + the first row whose filter type is not 0-4. */
int png_unfilter(const uint8_t *raw, uint8_t *out, int height, int stride,
                 int bpp) {
  for (int y = 0; y < height; y++) {
    const uint8_t *in = raw + (size_t)y * (stride + 1);
    int kind = in[0];
    in++;
    uint8_t *cur = out + (size_t)y * stride;
    const uint8_t *up = y ? cur - stride : 0;
    switch (kind) {
      case 0:
        memcpy(cur, in, (size_t)stride);
        break;
      case 1:
        for (int i = 0; i < stride; i++)
          cur[i] = (uint8_t)(in[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int i = 0; i < stride; i++)
          cur[i] = (uint8_t)(in[i] + (up ? up[i] : 0));
        break;
      case 3:
        for (int i = 0; i < stride; i++) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          int above = up ? up[i] : 0;
          cur[i] = (uint8_t)(in[i] + ((left + above) >> 1));
        }
        break;
      case 4:
        for (int i = 0; i < stride; i++) {
          int left = i >= bpp ? cur[i - bpp] : 0;
          int above = up ? up[i] : 0;
          int corner = (up && i >= bpp) ? up[i - bpp] : 0;
          cur[i] = (uint8_t)(in[i] + paeth(left, above, corner));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
