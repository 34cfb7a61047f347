/* Host C of the port's decode: the Ogg page walk, the whole-stream
 * packet parser (Huffman floor and residue reads, residue accumulate,
 * inverse coupling, floor0 and floor1 render and multiply), the
 * bit-exact IMDCT (scalar and 16-lane), the windowed lapped
 * overlap-add, and the fused whole-stream drain.
 *
 * Copies of the decode half of native/vorbisnative.c, function for
 * function and with the same names and text: rd_bits (:42-65),
 * vn_ogg_crc (:138-156), and everything from the parser's banner
 * (:249) to the end of vn_ogg_scan (:2032).  No encoder-side code.
 * vorbis_tpu_torch/native.py builds it at first use with
 * `cc -O3 -march=native -ffp-contract=off -fPIC -shared ... -lm`, as
 * native/build.sh builds the original: without -ffp-contract=off a
 * compiler may contract `r1*sn + r0*c` into an FMA and the IMDCT
 * would no longer equal the reference's separately rounded products.
 * Bound with ctypes by native.py and codec/nativeparse.py; the entry
 * points have plain C linkage. */

#include <stdint.h>
#include <string.h>

/* LSB-first bit reader over a byte buffer; returns value or -1 past
 * end (mirrors oggpack_read EOP semantics). */
static inline int64_t rd_bits(const uint8_t *data, long nbits_total,
                              long *pos, int n)
{
    long p = *pos;
    if (p + n > nbits_total) {
        *pos = nbits_total;
        return -1;
    }
    long byte = p >> 3;
    int bit = p & 7;
    uint64_t acc = 0;
    int got = 0;
    int k = 0;
    while (got < bit + n) {
        acc |= (uint64_t)data[byte + k] << (8 * k);
        got += 8;
        k++;
    }
    *pos = p + n;
    return (int64_t)((acc >> bit) & ((n >= 64) ? ~0ULL : ((1ULL << n) - 1)));
}


/* Ogg page CRC: poly 0x04c11db7, non-reflected, init/xorout 0
 * (reference: libogg crc_lookup usage in ogg_page_checksum_set). */
long vn_ogg_crc(const uint8_t *data, long n, uint32_t crc)
{
    static uint32_t tbl[256];
    static int init = 0;
    if (!init) {
        for (uint32_t i = 0; i < 256; i++) {
            uint32_t r = i << 24;
            for (int j = 0; j < 8; j++)
                r = (r << 1) ^ ((r & 0x80000000U) ? 0x04c11db7U : 0);
            tbl[i] = r;
        }
        init = 1;
    }
    for (long i = 0; i < n; i++)
        crc = (crc << 8) ^ tbl[((crc >> 24) & 0xFF) ^ data[i]];
    return (long)crc;
}

/* ===================================================================
 * Whole-stream audio packet parser + residue accumulator.
 *
 * The serial half of the decode drain (reference hot path:
 * lib/synthesis.c vorbis_synthesis -> lib/mapping0.c mapping0_inverse
 * -> lib/floor1.c floor1_inverse1 -> lib/res0.c _01inverse/res2_inverse
 * -> lib/codebook.c decode_packed_entry_number): every audio packet of
 * a stream is parsed in ONE native call, emitting dense arrays the
 * batched (numpy/TPU) synthesis consumes — unwrapped floor posts per
 * channel and fully accumulated float32 residue vectors.  Residue
 * value addition follows the reference's decodev_add/decodevs_add/
 * decodevv_add semantics exactly (float32 adds in decode order;
 * type-0 applies nothing on a truncated call; types 1/2 keep partial
 * entries; full-dim writes per entry).
 *
 * Restrictions (caller falls back to the scalar path otherwise):
 * floor type 1 only.  Multi-submap mappings (e.g. 5.1) ARE supported:
 * per-channel floor/residue configs are flattened per chmux entry.
 *
 * Config/book tables are flat int32/float arrays marshaled by
 * vorbis_tpu/codec/nativeparse.py; see that file for layouts.
 */

#define VN_K1 10

static inline long vn_huff1(const uint8_t *data, long nbits_total,
                            long *pos, const int32_t *t1,
                            const int32_t *sec, const int64_t *soff,
                            int K2)
{
    long p = *pos;
    long byte = p >> 3;
    int bit = p & 7;
    /* one unaligned 8-byte load (the caller pads the packet blob
     * with 8 slack bytes so the read is always in bounds), then mask
     * to the packet's true bit length — oggpack_look ZERO-extends
     * past end, and a tail that borrows the next packet's bits could
     * decode a spurious symbol instead of stopping.  Needed bits:
     * bit(<=7) + K1(10) + K2(<=22) <= 39 < 57. */
    uint64_t acc;
    memcpy(&acc, data + byte, 8);
    {
        long avail = nbits_total - (byte << 3);
        if (avail <= 0)
            acc = 0;
        else if (avail < 64)
            acc &= (~0ULL) >> (64 - avail);
    }
    uint64_t word = (acc >> bit) & ((1ULL << VN_K1) - 1);
    int32_t t = t1[word];
    int entry, len;
    if (t >= 0) {
        entry = t >> 6;
        len = t & 63;
    } else if (t <= -2) {
        long s = -(long)t - 2;
        uint64_t w2 = (acc >> (bit + VN_K1)) & ((1ULL << K2) - 1);
        const int32_t *t2 = sec + soff[s];
        int32_t u = t2[w2];
        if (u < 0) {
            *pos = nbits_total;
            return -1;
        }
        entry = u >> 6;
        len = u & 63;
    } else {
        *pos = nbits_total;
        return -1;
    }
    if (p + len > nbits_total) {
        *pos = nbits_total;
        return -1;
    }
    *pos = p + len;
    return entry;
}

typedef struct {
    const int32_t *t1;
    const int32_t *sec;
    const int64_t *soff;
    int K2;
    const float *vals;
    int dim;
} vn_book;

/* Register-windowed LSB-first bit reader for the packet-parse hot
 * loop: one unaligned 8-byte load amortizes over several symbols
 * (vn_huff1 reloaded+masked per symbol).  Zero-extension past the
 * packet's true bit length and the post-lookup EOP check reproduce
 * oggpack_look/oggpack_read semantics exactly, so decode results are
 * bit-identical to the per-symbol reader. */
typedef struct {
    const uint8_t *d;
    long nbits;
    long pos;       /* bits consumed */
    uint64_t acc;   /* bits [pos, pos+nacc), zero-extended past end */
    int nacc;
} vn_rd;

static inline void vn_rd_load(vn_rd *r)
{
    long byte = r->pos >> 3;
    int bit = r->pos & 7;
    uint64_t a;
    long avail;
    memcpy(&a, r->d + byte, 8);
    avail = r->nbits - (byte << 3);
    if (avail <= 0)
        a = 0;
    else if (avail < 64)
        a &= (~0ULL) >> (64 - avail);
    r->acc = a >> bit;
    r->nacc = 57 - bit;
}

static inline void vn_rd_init(vn_rd *r, const uint8_t *d, long nbits)
{
    r->d = d;
    r->nbits = nbits;
    r->pos = 0;
    vn_rd_load(r);
}

static inline int64_t vn_rd_bits(vn_rd *r, int n)
{
    if (n > 49) {
        /* wide fields (e.g. a 63-bit floor0 amp): the window holds
         * >= 50 valid bits after a reload, so split LSB-first */
        int64_t lo = vn_rd_bits(r, 32);
        int64_t hi;
        if (lo < 0)
            return -1;
        hi = vn_rd_bits(r, n - 32);
        if (hi < 0)
            return -1;
        return lo | (hi << 32);
    }
    if (r->pos + n > r->nbits) {
        r->pos = r->nbits;
        return -1;
    }
    if (r->nacc < n)
        vn_rd_load(r);
    {
        int64_t v = (int64_t)(r->acc & ((1ULL << n) - 1));
        r->pos += n;
        r->acc >>= n;
        r->nacc -= n;
        return v;
    }
}

static inline long vn_rd_huff(vn_rd *r, const vn_book *b)
{
    uint64_t word;
    int32_t t;
    int entry, len;
    if (r->nacc < VN_K1 + b->K2)
        vn_rd_load(r);
    word = r->acc & ((1ULL << VN_K1) - 1);
    t = b->t1[word];
    if (t >= 0) {
        entry = t >> 6;
        len = t & 63;
    } else if (t <= -2) {
        long s = -(long)t - 2;
        uint64_t w2 = (r->acc >> VN_K1) & ((1ULL << b->K2) - 1);
        const int32_t *t2 = b->sec + b->soff[s];
        int32_t u = t2[w2];
        if (u < 0) {
            r->pos = r->nbits;
            return -1;
        }
        entry = u >> 6;
        len = u & 63;
    } else {
        r->pos = r->nbits;
        return -1;
    }
    if (r->pos + len > r->nbits) {
        r->pos = r->nbits;
        return -1;
    }
    r->pos += len;
    r->acc >>= len;
    r->nacc -= len;
    return entry;
}

/* floor cfg int32 layout (see nativeparse.py), TYPE-TAGGED:
 * cfg[0] = floor type (0 or 1), then the per-type payload:
 * type 1: [posts, quantbits, partitions, quant_q, nclasses,
 *          partitionclass[partitions],
 *          nclasses * 11: (dim, subs, classbook, subbook[8]),
 *          postlist[posts], loneighbor[posts-2], hineighbor[posts-2],
 *          mult, forward_index[posts]]
 * type 0: [order, ampbits, ampdB, numbooks, bookids[numbooks],
 *          barkmap, linearmap0[bs0/2+1], linearmap1[bs1/2+1]] */

#include <math.h>

static inline int vn_ilog(unsigned long v)
{
    int r = 0;
    while (v) {
        r++;
        v >>= 1;
    }
    return r;
}

#define VN_LSP_MAX 512

/* vorbis_lsp_to_curve, the float non-lookup variant (lsp.c:248-281;
 * the reference build #undefs FLOAT_LOOKUP/INT_LOOKUP) — multiplies
 * the envelope gain into a[0:n2].  Same mixed float/double expression
 * tree as codec/floor0_codec.floor0_curve (the repo's bit-exact
 * oracle): float products, double cos/sqrt/exp. */
static void vn_floor0_curve(const float *lsp, int m, float amp,
                            int ampdB, const int32_t *map, long n2,
                            int ln, float *a)
{
    float wdel = (float)(M_PI / ln);
    float lc[VN_LSP_MAX];
    double ampd = (double)amp;
    double ampoff = (double)ampdB;
    long i = 0;
    for (int j = 0; j < m; j++)
        lc[j] = 2.f * (float)cos((double)lsp[j]);
    while (i < n2) {
        int k = map[i];
        float p = .5f, q = .5f;
        float wk = wdel * (float)k;
        float w = 2.f * (float)cos((double)wk);
        int j;
        for (j = 1; j < m; j += 2) {
            q *= w - lc[j - 1];
            p *= w - lc[j];
        }
        if (j == m) {
            /* odd order */
            q *= w - lc[j - 1];
            p *= p * (4.f - w * w);
            q *= q;
        } else {
            p *= p * (2.f - w);
            q *= q * (2.f + w);
        }
        {
            double v = ampd / sqrt((double)(p + q)) - ampoff;
            float qv = (float)exp(v * (double).11512925f);
            a[i] *= qv;
            i++;
            while (i < n2 && map[i] == k) {
                a[i] *= qv;
                i++;
            }
        }
    }
}

/* res cfg int32 layout:
 * [0]=type [1]=begin [2]=end [3]=grouping [4]=possible [5]=stages
 * [6]=phrasebook [7]=ppw [8]=partvals_limit
 * [9..9+possible) secondstages
 * then partbooks[possible*stages] (book index or -1) */

static long vn_render_pt(long x0, long x1, long y0, long y1, long x)
{
    y0 &= 0x7FFF;
    y1 &= 0x7FFF;
    {
        long dy = y1 - y0;
        long adx = x1 - x0;
        long ady = dy < 0 ? -dy : dy;
        long err = ady * (x - x0);
        long off = err / adx;
        return dy < 0 ? y0 - off : y0 + off;
    }
}

/* All stream-level decode configuration bundled for the per-packet
 * parser (built once per call from the flat arrays nativeparse.py
 * marshals). */
typedef struct {
    int ch, modebits, nmodes, nmaps, submax, maxcpl;
    int bs0, bs1, Pmax, n2max, pwmax;
    const int32_t *mode_blockflag, *mode_map, *map_submaps, *map_chmux,
        *map_floorsub, *map_ressub, *cpl_count, *cpl_mag, *cpl_ang;
    const int32_t *flcfg;
    const int64_t *flcfg_off;
    const int32_t *rescfg;
    const int64_t *rescfg_off;
    const float *fromdB;
    const vn_book *books;
} vn_pctx;

/* Parse ONE audio packet: floor posts (floor1_inverse1 + unwrap),
 * residue accumulate, inverse coupling, floor render+multiply.  res
 * (ch*n2max) is zeroed here; *W_out = -1 flags bad/non-audio.
 * (Body indentation is inherited from the original whole-stream loop
 * this was extracted from.) */
static void vn_parse_one(const vn_pctx *cx, const uint8_t *pd, long nbits,
                         int32_t *W_out, int32_t *mode_out,
                         int32_t *posts, uint8_t *nz, float *res,
                         int32_t *partword_buf)
{
    const vn_book *books = cx->books;
    int ch = cx->ch, modebits = cx->modebits, nmodes = cx->nmodes;
    int submax = cx->submax, maxcpl = cx->maxcpl;
    int bs0 = cx->bs0, bs1 = cx->bs1, Pmax = cx->Pmax;
    int n2max = cx->n2max, pwmax = cx->pwmax;
    const int32_t *mode_blockflag = cx->mode_blockflag;
    const int32_t *mode_map = cx->mode_map;
    const int32_t *map_submaps = cx->map_submaps;
    const int32_t *map_chmux = cx->map_chmux;
    const int32_t *map_floorsub = cx->map_floorsub;
    const int32_t *map_ressub = cx->map_ressub;
    const int32_t *cpl_count = cx->cpl_count;
    const int32_t *cpl_mag = cx->cpl_mag;
    const int32_t *cpl_ang = cx->cpl_ang;
    const int32_t *flcfg = cx->flcfg;
    const int64_t *flcfg_off = cx->flcfg_off;
    const int32_t *rescfg = cx->rescfg;
    const int64_t *rescfg_off = cx->rescfg_off;
    const float *fromdB = cx->fromdB;
    {
        vn_rd rd;
        vn_rd_init(&rd, pd, nbits);
        memset(res, 0, (size_t)ch * n2max * sizeof(float));
        *W_out = -1;
        *mode_out = -1;
        for (int c = 0; c < ch; c++)
            nz[c] = 0;

        long b0 = vn_rd_bits(&rd, 1);
        if (b0 != 0)
            return;
        long mode = vn_rd_bits(&rd, modebits);
        if (mode < 0 || mode >= nmodes)
            return;
        int W = mode_blockflag[mode];
        if (W) {
            if (vn_rd_bits(&rd, 2) < 0)
                return;         /* OV_EBADPACKET in the reference */
        }
        *W_out = W;
        *mode_out = (int32_t)mode;
        long n2 = (W ? bs1 : bs0) / 2;
        int mapidx = mode_map[mode];
        const int32_t *chmux = map_chmux + (long)mapidx * ch;
        const int32_t *floorsub = map_floorsub + (long)mapidx * submax;
        const int32_t *ressub = map_ressub + (long)mapidx * submax;
        int submaps = map_submaps[mapidx];

        /* ---- floors (floor1_inverse1 incl. unwrap / floor0_inverse1
         * LSP decode), per channel in channel order, each with its
         * submap's floor config ---- */
        for (int c = 0; c < ch; c++) {
            const int32_t *fc = flcfg + flcfg_off[floorsub[chmux[c]]];
            int ftype = fc[0];
            fc++;
            if (ftype == 0) {
                /* floor0_inverse1 (floor0.c:162-198): amp, book
                 * number, decodev_set LSP coefficients with the
                 * cumulative `last` add.  The memo (m floats + amp)
                 * is stashed in the posts row as raw float bits for
                 * the render stage. */
                int m = fc[0], ampbits = fc[1], ampdB = fc[2];
                int nbks = fc[3];
                const int32_t *bids = fc + 4;
                int32_t *fit = posts + c * Pmax;
                long ampraw = vn_rd_bits(&rd, ampbits);
                if (ampraw <= 0)
                    continue;       /* unused channel (or EOP) */
                {
                    long maxval = (1L << ampbits) - 1;
                    /* double-divide then f32, like the scalar oracle
                     * (floor0_codec.decode_floor0) */
                    float q32 = (float)((double)ampraw / maxval);
                    float ampf = (float)((double)q32 * ampdB);
                    long booknum = vn_rd_bits(&rd, vn_ilog(nbks));
                    const vn_book *b;
                    float lsp[VN_LSP_MAX];
                    int dim, i2 = 0, dead = 0;
                    if (booknum < 0 || booknum >= nbks)
                        continue;
                    b = &books[bids[booknum]];
                    dim = b->dim;
                    if (m + dim > VN_LSP_MAX || m + 1 > Pmax)
                        continue;
                    while (i2 < m) {
                        long e = vn_rd_huff(&rd, b);
                        if (e < 0) {
                            dead = 1;
                            break;
                        }
                        {
                            const float *v = b->vals + e * dim;
                            for (int k = 0; k < dim; k++)
                                lsp[i2 + k] = v[k];
                        }
                        i2 += dim;
                    }
                    if (dead)
                        continue;
                    {
                        float last = 0.f;
                        int j = 0;
                        while (j < m) {
                            for (int k = 0; k < dim && j < m;
                                 k++, j++)
                                lsp[j] += last;
                            last = lsp[j - 1];
                        }
                    }
                    memcpy(fit, lsp, (size_t)m * sizeof(float));
                    memcpy(fit + m, &ampf, sizeof(float));
                    nz[c] = 1;
                }
                continue;
            }
            int P = fc[0], qbits = fc[1], partitions = fc[2];
            long quant_q = fc[3];
            int nclasses = fc[4];
            const int32_t *pclass = fc + 5;
            const int32_t *cls_tab = fc + 5 + partitions;
            const int32_t *postlist = cls_tab + nclasses * 11;
            const int32_t *lonb = postlist + P;
            const int32_t *hinb = lonb + (P - 2);
            int32_t *fit = posts + c * Pmax;
            for (int i = 0; i < P; i++)
                fit[i] = 0;
            long one = vn_rd_bits(&rd, 1);
            if (one != 1)
                continue;       /* unused channel (or EOP) */
            long f0 = vn_rd_bits(&rd, qbits);
            long f1 = vn_rd_bits(&rd, qbits);
            if (f0 < 0 || f1 < 0)
                continue;
            fit[0] = (int32_t)f0;
            fit[1] = (int32_t)f1;
            int j = 2, dead = 0;
            for (int i = 0; i < partitions && !dead; i++) {
                int cl = pclass[i];
                const int32_t *ct = cls_tab + cl * 11;
                int cdim = ct[0], csubbits = ct[1];
                int csub = 1 << csubbits;
                long cval = 0;
                if (csubbits) {
                    int bk = ct[2];
                    cval = vn_rd_huff(&rd, &books[bk]);
                    if (cval < 0) {
                        dead = 1;
                        break;
                    }
                }
                for (int k = 0; k < cdim; k++) {
                    int bk = ct[3 + (cval & (csub - 1))];
                    cval >>= csubbits;
                    if (bk >= 0) {
                        long e = vn_rd_huff(&rd, &books[bk]);
                        if (e < 0) {
                            dead = 1;
                            break;
                        }
                        fit[j + k] = (int32_t)e;
                    } else {
                        fit[j + k] = 0;
                    }
                }
                j += cdim;
            }
            if (dead)
                continue;       /* EOP mid-floor: channel unused */
            /* unwrap predictions */
            for (int i = 2; i < P; i++) {
                int lo = lonb[i - 2], hi = hinb[i - 2];
                long pred = vn_render_pt(postlist[lo], postlist[hi],
                                         fit[lo], fit[hi], postlist[i]);
                long hiroom = quant_q - pred;
                long loroom = pred;
                long room = (hiroom < loroom ? hiroom : loroom) << 1;
                long val = fit[i];
                if (val) {
                    if (val >= room) {
                        val = hiroom > loroom ? val - loroom
                                              : -1 - (val - hiroom);
                    } else {
                        val = (val & 1) ? -((val + 1) >> 1) : (val >> 1);
                    }
                    fit[i] = (int32_t)((val + pred) & 0x7FFF);
                    fit[lo] &= 0x7FFF;
                    fit[hi] &= 0x7FFF;
                } else {
                    fit[i] = (int32_t)(pred | 0x8000);
                }
            }
            nz[c] = 1;
        }

        /* ---- coupling nonzero propagation ---- */
        uint8_t dnd[64];         /* do-not-decode per channel */
        {
            uint8_t nz2[64];
            for (int c = 0; c < ch; c++)
                nz2[c] = nz[c];
            int nc = cpl_count[mapidx];
            const int32_t *cm = cpl_mag + (long)mapidx * maxcpl;
            const int32_t *ca = cpl_ang + (long)mapidx * maxcpl;
            for (int k = 0; k < nc; k++) {
                if (nz2[cm[k]] || nz2[ca[k]]) {
                    nz2[cm[k]] = 1;
                    nz2[ca[k]] = 1;
                }
            }
            for (int c = 0; c < ch; c++)
                dnd[c] = !nz2[c];
        }

        /* ---- residues, per submap ---- */
        for (int sm = 0; sm < submaps; sm++) {
            int chans[64];
            int nch = 0;
            for (int c = 0; c < ch; c++)
                if (chmux[c] == sm)
                    chans[nch++] = c;
            if (!nch)
                continue;
            const int32_t *rc = rescfg + rescfg_off[ressub[sm]];
            int rtype = rc[0];
            long begin = rc[1], end = rc[2], grouping = rc[3];
            int possible = rc[4], stages = rc[5];
            int phb = rc[6], ppw = rc[7];
            long pv_limit = rc[8];
            const int32_t *secondstages = rc + 9;
            const int32_t *partbooks = rc + 9 + possible;

            if (rtype == 2) {
                int any = 0;
                for (int j = 0; j < nch; j++)
                    if (!dnd[chans[j]])
                        any = 1;
                if (!any)
                    continue;
                long maxv = n2 * nch;
                long e2 = end < maxv ? end : maxv;
                long n = e2 - begin;
                if (n <= 0)
                    continue;
                long partvals = n / grouping;
                long partwords = (partvals + ppw - 1) / ppw;
                if (partwords * ppw > pwmax)
                    continue;
                int32_t *pw = partword_buf;
                int eop = 0;
                for (int s = 0; s < stages && !eop; s++) {
                    long i = 0, l = 0;
                    while (i < partvals && !eop) {
                        if (s == 0) {
                            long temp = vn_rd_huff(&rd, &books[phb]);
                            if (temp < 0 || temp >= pv_limit) {
                                eop = 1;
                                break;
                            }
                            for (int k = ppw - 1; k >= 0; k--) {
                                pw[l * ppw + k] =
                                    (int32_t)(temp % possible);
                                temp /= possible;
                            }
                        }
                        for (int k = 0; k < ppw && i < partvals && !eop;
                             k++, i++) {
                            int cls = pw[l * ppw + k];
                            if (!(secondstages[cls] & (1 << s)))
                                continue;
                            int bk = partbooks[cls * stages + s];
                            if (bk < 0)
                                continue;
                            /* decodevv_add over the submap bundle */
                            {
                                long offset = begin + i * grouping;
                                long lo = offset / nch;
                                long hi2 = (offset + grouping) / nch;
                                int dim = books[bk].dim;
                                const float *bv = books[bk].vals;
                                int chptr = 0;
                                long ii = lo;
                                while (ii < hi2) {
                                    long e = vn_rd_huff(&rd, &books[bk]);
                                    if (e < 0) {
                                        eop = 1;
                                        break;
                                    }
                                    const float *t = bv + e * dim;
                                    /* full dim per entry, no mid-entry
                                     * stop — matches decodevv_add (i
                                     * can pass the range end inside
                                     * the final entry) */
                                    for (int jj = 0; jj < dim; jj++) {
                                        if (ii < n2max)
                                            res[chans[chptr] * n2max
                                                + ii] += t[jj];
                                        if (++chptr == nch) {
                                            chptr = 0;
                                            ii++;
                                        }
                                    }
                                }
                            }
                        }
                        l++;
                    }
                }
                continue;
            }

            /* types 0/1 */
            {
                int used[64];
                int nused = 0;
                for (int j = 0; j < nch; j++)
                    if (!dnd[chans[j]])
                        used[nused++] = chans[j];
                if (!nused)
                    continue;
                long e2 = end < n2 ? end : n2;
                long n = e2 - begin;
                if (n <= 0)
                    continue;
                long partvals = n / grouping;
                long partwords = (partvals + ppw - 1) / ppw;
                if (partwords * ppw > pwmax)
                    continue;
                int eop = 0;
                for (int s = 0; s < stages && !eop; s++) {
                    long i = 0, l = 0;
                    while (i < partvals && !eop) {
                        if (s == 0) {
                            for (int j = 0; j < nused; j++) {
                                long temp = vn_rd_huff(&rd, &books[phb]);
                                if (temp < 0 || temp >= pv_limit) {
                                    eop = 1;
                                    break;
                                }
                                for (int k = ppw - 1; k >= 0; k--) {
                                    partword_buf[(j * pwmax)
                                                 + l * ppw + k] =
                                        (int32_t)(temp % possible);
                                    temp /= possible;
                                }
                            }
                            if (eop)
                                break;
                        }
                        for (int k = 0; k < ppw && i < partvals && !eop;
                             k++, i++) {
                            for (int j = 0; j < nused && !eop; j++) {
                                int cls = partword_buf[j * pwmax
                                                       + l * ppw + k];
                                if (!(secondstages[cls] & (1 << s)))
                                    continue;
                                int bk = partbooks[cls * stages + s];
                                if (bk < 0)
                                    continue;
                                {
                                    long offset = begin + i * grouping;
                                    int dim = books[bk].dim;
                                    const float *bv = books[bk].vals;
                                    float *a = res + used[j] * n2max;
                                    if (rtype == 1) {
                                        /* decodev_add: partial entries
                                         * kept, full dim per entry */
                                        long ii = 0;
                                        while (ii < grouping) {
                                            long e = vn_rd_huff(&rd, &books[bk]);
                                            if (e < 0) {
                                                eop = 1;
                                                break;
                                            }
                                            const float *t = bv
                                                + e * dim;
                                            for (int jj = 0; jj < dim;
                                                 jj++) {
                                                long x = offset + ii++;
                                                if (x < n2max)
                                                    a[x] += t[jj];
                                            }
                                        }
                                    } else {
                                        /* decodevs_add: all entries
                                         * decode first; truncated call
                                         * applies NOTHING */
                                        long step = grouping / dim;
                                        long ents[512];
                                        if (step > 512) {
                                            eop = 1;
                                            break;
                                        }
                                        for (long t2 = 0; t2 < step;
                                             t2++) {
                                            ents[t2] = vn_rd_huff(&rd, &books[bk]);
                                            if (ents[t2] < 0) {
                                                eop = 1;
                                                break;
                                            }
                                        }
                                        if (eop)
                                            break;
                                        for (int d = 0; d < dim; d++) {
                                            long o = offset + d * step;
                                            for (long t2 = 0; t2 < step;
                                                 t2++) {
                                                long x = o + t2;
                                                if (x < n2max)
                                                    a[x] += bv[
                                                        ents[t2] * dim
                                                        + d];
                                            }
                                        }
                                    }
                                }
                            }
                        }
                        l++;
                    }
                }
            }
        }

        /* ---- inverse coupling (mapping0.c:1380-1477), reversed
         * order, over the full spectrum half ---- */
        {
            int nc = cpl_count[mapidx];
            const int32_t *cm = cpl_mag + (long)mapidx * maxcpl;
            const int32_t *ca = cpl_ang + (long)mapidx * maxcpl;
            for (int k = nc - 1; k >= 0; k--) {
                float *M = res + cm[k] * n2max;
                float *A = res + ca[k] * n2max;
                for (long i = 0; i < n2; i++) {
                    float mag = M[i], ang = A[i];
                    if (mag > 0.f) {
                        if (ang > 0.f) {
                            M[i] = mag;
                            A[i] = mag - ang;
                        } else {
                            M[i] = mag + ang;
                            A[i] = mag;
                        }
                    } else {
                        if (ang > 0.f) {
                            M[i] = mag;
                            A[i] = mag + ang;
                        } else {
                            M[i] = mag - ang;
                            A[i] = mag;
                        }
                    }
                }
            }
        }

        /* ---- floor render + multiply (floor1_inverse2: render_line
         * DDA over sorted used posts, fromdB gain per bin).  Channels
         * with an unused floor zero out (mapping0.c:1480-1486). ---- */
        for (int c = 0; c < ch; c++) {
            float *a = res + c * n2max;
            if (!nz[c]) {
                for (long i = 0; i < n2max; i++)
                    a[i] = 0.f;
                continue;
            }
            {
                const int32_t *fc = flcfg
                    + flcfg_off[floorsub[chmux[c]]];
                int ftype = fc[0];
                fc++;
                if (ftype == 0) {
                    /* floor0_inverse2: LSP memo -> envelope multiply
                     * over the full half-spectrum */
                    int m = fc[0], ampdB = fc[2], nbks = fc[3];
                    const int32_t *tail = fc + 4 + nbks;
                    int ln = tail[0];
                    const int32_t *map0 = tail + 1;
                    const int32_t *map1 = map0 + (bs0 / 2 + 1);
                    const int32_t *map = (n2 == bs0 / 2) ? map0
                                                         : map1;
                    const int32_t *fit = posts + c * Pmax;
                    float lspv[VN_LSP_MAX];
                    float ampf;
                    memcpy(lspv, fit, (size_t)m * sizeof(float));
                    memcpy(&ampf, fit + m, sizeof(float));
                    vn_floor0_curve(lspv, m, ampf, ampdB, map, n2,
                                    ln, a);
                    for (long x = n2; x < n2max; x++)
                        a[x] = 0.f;
                    continue;
                }
                int P = fc[0], partitions = fc[2];
                int nclasses = fc[4];
                const int32_t *postlist = fc + 5 + partitions
                    + nclasses * 11;
                const int32_t *tail = postlist + P + 2 * (P - 2);
                int mult = tail[0];
                const int32_t *fwdi = tail + 1;
                const int32_t *fit = posts + c * Pmax;
                long lx = 0;
                long ly = (long)fit[0] * mult;
                if (ly < 0)
                    ly = 0;
                if (ly > 255)
                    ly = 255;
                long hx = 0;
                for (int j = 1; j < P; j++) {
                    int cur = fwdi[j];
                    long hyraw = fit[cur] & 0x7FFF;
                    if (hyraw != fit[cur])
                        continue;       /* interpolated post */
                    hx = postlist[cur];
                    {
                        long hy = hyraw * mult;
                        if (hy < 0)
                            hy = 0;
                        if (hy > 255)
                            hy = 255;
                        {
                            /* incremental Bresenham DDA — identical
                             * integer sequence to floor1.c render_line
                             * (y_k = ly + base*k + sgn*((k*ady)/adx)
                             * with the error accumulator stepping),
                             * no per-bin division */
                            long dy = hy - ly;
                            long adx = hx - lx;
                            long base = dy / adx;   /* trunc == C */
                            long ady = (dy < 0 ? -dy : dy)
                                - (base < 0 ? -base : base) * adx;
                            long end = hx < n2 ? hx : n2;
                            long sy = dy < 0 ? base - 1 : base + 1;
                            long yv = ly;
                            long err = 0;
                            for (long x = lx; x < end; x++) {
                                a[x] *= fromdB[yv];
                                err += ady;
                                if (err >= adx) {
                                    err -= adx;
                                    yv += sy;
                                } else {
                                    yv += base;
                                }
                            }
                        }
                        lx = hx;
                        ly = hy;
                    }
                }
                for (long x = (hx > 0 ? hx : 0); x < n2; x++)
                    a[x] *= fromdB[ly];
                for (long x = n2; x < n2max; x++)
                    a[x] = 0.f;
            }
        }
    }
}

/* Build the parse context from the flat marshaled arrays.  Returns -1
 * on limits violation. */
static long vn_pctx_init(
    vn_pctx *cx, vn_book *books,
    int ch, int modebits, int nmodes, int nmaps, int submax,
    const int32_t *mode_blockflag, const int32_t *mode_map,
    const int32_t *map_submaps, const int32_t *map_chmux,
    const int32_t *map_floorsub, const int32_t *map_ressub,
    const int32_t *cpl_count, const int32_t *cpl_mag,
    const int32_t *cpl_ang, int maxcpl,
    const int32_t *t1_all, const int32_t *sec_all,
    const int64_t *soff_all, const int64_t *book_secbase,
    const int64_t *book_soffbase, const int32_t *book_K2,
    const float *vals_all, const int64_t *book_valbase,
    const int32_t *book_dim, int nbooks,
    const int32_t *flcfg, const int64_t *flcfg_off,
    const int32_t *rescfg, const int64_t *rescfg_off,
    const float *fromdB, int bs0, int bs1,
    int Pmax, int n2max, int pwmax)
{
    if (nbooks > 512 || ch > 64)
        return -1;
    for (int b = 0; b < nbooks; b++) {
        books[b].t1 = t1_all + (long)b * (1 << VN_K1);
        books[b].sec = sec_all + book_secbase[b];
        books[b].soff = soff_all + book_soffbase[b];
        books[b].K2 = book_K2[b];
        books[b].vals = vals_all + book_valbase[b];
        books[b].dim = book_dim[b];
    }
    cx->ch = ch; cx->modebits = modebits; cx->nmodes = nmodes;
    cx->nmaps = nmaps; cx->submax = submax; cx->maxcpl = maxcpl;
    cx->bs0 = bs0; cx->bs1 = bs1; cx->Pmax = Pmax;
    cx->n2max = n2max; cx->pwmax = pwmax;
    cx->mode_blockflag = mode_blockflag; cx->mode_map = mode_map;
    cx->map_submaps = map_submaps; cx->map_chmux = map_chmux;
    cx->map_floorsub = map_floorsub; cx->map_ressub = map_ressub;
    cx->cpl_count = cpl_count; cx->cpl_mag = cpl_mag;
    cx->cpl_ang = cpl_ang;
    cx->flcfg = flcfg; cx->flcfg_off = flcfg_off;
    cx->rescfg = rescfg; cx->rescfg_off = rescfg_off;
    cx->fromdB = fromdB;
    cx->books = books;
    return 0;
}

long vn_parse_packets(
    const uint8_t *data, const int64_t *pkt_off, const int64_t *pkt_bits,
    long npkt, int ch, int modebits, int nmodes, int nmaps, int submax,
    const int32_t *mode_blockflag, const int32_t *mode_map,
    const int32_t *map_submaps, const int32_t *map_chmux,
    const int32_t *map_floorsub, const int32_t *map_ressub,
    const int32_t *cpl_count, const int32_t *cpl_mag,
    const int32_t *cpl_ang, /* per MAP, flattened with stride maxcpl */
    int maxcpl,
    /* books */
    const int32_t *t1_all, const int32_t *sec_all,
    const int64_t *soff_all, const int64_t *book_secbase,
    const int64_t *book_soffbase, const int32_t *book_K2,
    const float *vals_all, const int64_t *book_valbase,
    const int32_t *book_dim, int nbooks,
    /* configs */
    const int32_t *flcfg, const int64_t *flcfg_off,
    const int32_t *rescfg, const int64_t *rescfg_off,
    const float *fromdB,          /* 256-entry floor gain table */
    int bs0, int bs1,
    /* outputs */
    int32_t *out_W,               /* npkt (-1 bad/non-audio) */
    int32_t *out_mode,            /* npkt */
    int32_t *out_posts,           /* npkt*ch*Pmax */
    uint8_t *out_nonzero,         /* npkt*ch */
    float *out_res,               /* npkt*ch*n2max */
    int Pmax, int n2max,
    /* scratch: ch*pwmax int32 */
    int32_t *partword_buf, int pwmax)
{
    vn_book books[512];
    vn_pctx cx;
    if (vn_pctx_init(&cx, books, ch, modebits, nmodes, nmaps, submax,
                     mode_blockflag, mode_map, map_submaps, map_chmux,
                     map_floorsub, map_ressub, cpl_count, cpl_mag,
                     cpl_ang, maxcpl, t1_all, sec_all, soff_all,
                     book_secbase, book_soffbase, book_K2, vals_all,
                     book_valbase, book_dim, nbooks, flcfg, flcfg_off,
                     rescfg, rescfg_off, fromdB, bs0, bs1,
                     Pmax, n2max, pwmax) < 0)
        return -1;
    for (long p = 0; p < npkt; p++)
        vn_parse_one(&cx, data + pkt_off[p], pkt_bits[p],
                     out_W + p, out_mode + p,
                     out_posts + (long)p * ch * Pmax,
                     out_nonzero + (long)p * ch,
                     out_res + (long)p * ch * n2max, partword_buf);
    return 0;
}

/* ===================================================================
 * Batched bit-exact IMDCT (reference: lib/mdct.c mdct_backward).
 *
 * Executes the SAME expression trees as vorbis_tpu/ops/mdct.py imdct()
 * — stage A pre-rotation through the precomputed gather tables, the
 * radix-2 cascade, the 32/16/8-point butterfly tails, bitreverse
 * rotation, final rotation + symmetric expansion — scalar per frame,
 * tables marshaled from Python.  Float32 ops in identical order =
 * bit-identical output (build with -ffp-contract=off; no FMA).
 */

static const float VN_cPI1_8 = 0.92387953f;
static const float VN_cPI2_8 = 0.70710678f;
static const float VN_cPI3_8 = 0.38268343f;

static void vn_bf8(float *x)
{
    float r0 = x[6] + x[2], r1 = x[6] - x[2];
    float r2 = x[4] + x[0], r3 = x[4] - x[0];
    float n6 = r0 + r2, n4 = r0 - r2;
    float s0 = x[5] - x[1], s2 = x[7] - x[3];
    float n0 = r1 + s0, n2 = r1 - s0;
    float u0 = x[5] + x[1], u1 = x[7] + x[3];
    float n3 = s2 + r3, n1 = s2 - r3;
    float n7 = u1 + u0, n5 = u1 - u0;
    x[0] = n0; x[1] = n1; x[2] = n2; x[3] = n3;
    x[4] = n4; x[5] = n5; x[6] = n6; x[7] = n7;
}

static void vn_bf16(float *x)
{
    float c2 = VN_cPI2_8;
    float r0 = x[1] - x[9], r1 = x[0] - x[8];
    float n8 = x[8] + x[0], n9 = x[9] + x[1];
    float n0 = (r0 + r1) * c2, n1 = (r0 - r1) * c2;
    float r0b = x[3] - x[11], r1b = x[10] - x[2];
    float n10 = x[10] + x[2], n11 = x[11] + x[3];
    float n2 = r0b, n3 = r1b;
    float r0c = x[12] - x[4], r1c = x[13] - x[5];
    float n12 = x[12] + x[4], n13 = x[13] + x[5];
    float n4 = (r0c - r1c) * c2, n5 = (r0c + r1c) * c2;
    float r0d = x[14] - x[6], r1d = x[15] - x[7];
    float n14 = x[14] + x[6], n15 = x[15] + x[7];
    float n6 = r0d, n7 = r1d;
    x[0] = n0; x[1] = n1; x[2] = n2; x[3] = n3;
    x[4] = n4; x[5] = n5; x[6] = n6; x[7] = n7;
    x[8] = n8; x[9] = n9; x[10] = n10; x[11] = n11;
    x[12] = n12; x[13] = n13; x[14] = n14; x[15] = n15;
    vn_bf8(x);
    vn_bf8(x + 8);
}

static void vn_bf32(float *x)
{
    float c1 = VN_cPI1_8, c2 = VN_cPI2_8, c3 = VN_cPI3_8;
    float r0 = x[30] - x[14], r1 = x[31] - x[15];
    float n30 = x[30] + x[14], n31 = x[31] + x[15];
    float n14 = r0, n15 = r1;
    float r0b = x[28] - x[12], r1b = x[29] - x[13];
    float n28 = x[28] + x[12], n29 = x[29] + x[13];
    float n12 = r0b * c1 - r1b * c3, n13 = r0b * c3 + r1b * c1;
    float r0c = x[26] - x[10], r1c = x[27] - x[11];
    float n26 = x[26] + x[10], n27 = x[27] + x[11];
    float n10 = (r0c - r1c) * c2, n11 = (r0c + r1c) * c2;
    float r0d = x[24] - x[8], r1d = x[25] - x[9];
    float n24 = x[24] + x[8], n25 = x[25] + x[9];
    float n8 = r0d * c3 - r1d * c1, n9 = r1d * c3 + r0d * c1;
    float r0e = x[22] - x[6], r1e = x[7] - x[23];
    float n22 = x[22] + x[6], n23 = x[23] + x[7];
    float n6 = r1e, n7 = r0e;
    float r0f = x[4] - x[20], r1f = x[5] - x[21];
    float n20 = x[20] + x[4], n21 = x[21] + x[5];
    float n4 = r1f * c1 + r0f * c3, n5 = r1f * c3 - r0f * c1;
    float r0g = x[2] - x[18], r1g = x[3] - x[19];
    float n18 = x[18] + x[2], n19 = x[19] + x[3];
    float n2 = (r1g + r0g) * c2, n3 = (r1g - r0g) * c2;
    float r0h = x[0] - x[16], r1h = x[1] - x[17];
    float n16 = x[16] + x[0], n17 = x[17] + x[1];
    float n0 = r1h * c3 + r0h * c1, n1 = r1h * c1 - r0h * c3;
    x[0] = n0; x[1] = n1; x[2] = n2; x[3] = n3;
    x[4] = n4; x[5] = n5; x[6] = n6; x[7] = n7;
    x[8] = n8; x[9] = n9; x[10] = n10; x[11] = n11;
    x[12] = n12; x[13] = n13; x[14] = n14; x[15] = n15;
    x[16] = n16; x[17] = n17; x[18] = n18; x[19] = n19;
    x[20] = n20; x[21] = n21; x[22] = n22; x[23] = n23;
    x[24] = n24; x[25] = n25; x[26] = n26; x[27] = n27;
    x[28] = n28; x[29] = n29; x[30] = n30; x[31] = n31;
    vn_bf16(x);
    vn_bf16(x + 16);
}

/* IMDCT lookup-table bundle (field order mirrored by the ctypes
 * _ImTab struct in vorbis_tpu/native.py). */
typedef struct {
    int32_t n, nstages;
    const float *T, *sa, *sb;
    const int32_t *ia, *ib, *ta, *tb, *stageP, *tc_all;
    const int32_t *e0, *e1, *tC, *tD;
    const int64_t *stage_off;
} vn_imtab;

/* One frame's IMDCT: x (n/2) -> o (n); y is n/2 scratch.  Exact same
 * expression trees as the original whole-batch loop. */
static void vn_imdct1(const vn_imtab *t, const float *x, float *o,
                      float *y)
{
    int n = t->n;
    int n2 = n >> 1, n4 = n >> 2, n8 = n >> 3;
    const float *T = t->T, *sa = t->sa, *sb = t->sb;
    const int32_t *ia = t->ia, *ib = t->ib, *ta = t->ta, *tb = t->tb;
    const int32_t *stageP = t->stageP;
    const int64_t *stage_off = t->stage_off;
    int nstages = t->nstages;
    const int32_t *tc_all = t->tc_all;
    const int32_t *e0 = t->e0, *e1 = t->e1, *tC = t->tC, *tD = t->tD;
    {

        /* stage A: pre-rotation */
        for (int i = 0; i < n2; i++)
            y[i] = sa[i] * x[ia[i]] * T[ta[i]]
                 + sb[i] * x[ib[i]] * T[tb[i]];

        /* stage B: radix-2 cascade */
        for (int s = 0; s < nstages; s++) {
            int P = stageP[s];
            const int32_t *tc = tc_all + stage_off[s];
            int half = P >> 1, nc = P >> 2;
            for (int b = 0; b < n2 / P; b++) {
                float *lo = y + b * P;
                float *hi = lo + half;
                for (int m = 0; m < nc; m++) {
                    float h0 = hi[2 * m], h1 = hi[2 * m + 1];
                    float l0 = lo[2 * m], l1 = lo[2 * m + 1];
                    float r0 = h0 - l0, r1 = h1 - l1;
                    float c = T[tc[m]], sn = T[tc[m] + 1];
                    hi[2 * m] = h0 + l0;
                    hi[2 * m + 1] = h1 + l1;
                    lo[2 * m] = r1 * sn + r0 * c;
                    lo[2 * m + 1] = r1 * c - r0 * sn;
                }
            }
        }
        for (int b = 0; b < n2 / 32; b++)
            vn_bf32(y + b * 32);

        /* stage C: bitreverse + half-angle rotation into o[0:n2]
         * (z buffer) */
        {
            float *z = o;        /* reuse output low half as z scratch */
            for (int m = 0; m < n8; m++) {
                float a0 = y[e0[m]], a1 = y[e0[m] + 1];
                float b0 = y[e1[m]], b1 = y[e1[m] + 1];
                float c = T[tC[m]], sn = T[tC[m] + 1];
                float r0 = a1 - b1, r1 = a0 + b0;
                float r2 = r1 * c + r0 * sn;
                float r3 = r1 * sn - r0 * c;
                float r0h = 0.5f * (a1 + b1);
                float r1h = 0.5f * (a0 - b0);
                z[2 * m] = r0h + r2;
                z[2 * m + 1] = r1h + r3;
                z[n4 + 2 * (n8 - 1 - m)] = r0h - r2;
                z[n4 + 2 * (n8 - 1 - m) + 1] = r3 - r1h;
            }
            /* stage D: final rotation + symmetric expansion.  a/b are
             * computed into y[] first since o aliases z. */
            for (int i = 0; i < n4; i++) {
                float z0 = z[2 * i], z1 = z[2 * i + 1];
                float c = T[tD[i]], sn = T[tD[i] + 1];
                y[i] = z0 * sn - z1 * c;            /* a[i] */
                y[n4 + i] = -(z0 * c + z1 * sn);    /* b[i] */
            }
            for (int i = 0; i < n4; i++) {
                o[i] = y[n4 - 1 - i];
                o[n4 + i] = -y[i];
                o[n2 + i] = y[n4 + (n4 - 1 - i)];
                o[n2 + n4 + i] = y[n4 + i];
            }
        }
    }
}

static void vn_imtab_init(vn_imtab *t, int n, const float *T,
                          const int32_t *ia, const int32_t *ib,
                          const int32_t *ta, const int32_t *tb,
                          const float *sa, const float *sb,
                          const int32_t *stageP,
                          const int64_t *stage_off, int nstages,
                          const int32_t *tc_all, const int32_t *e0,
                          const int32_t *e1, const int32_t *tC,
                          const int32_t *tD)
{
    t->n = n; t->nstages = nstages;
    t->T = T; t->sa = sa; t->sb = sb;
    t->ia = ia; t->ib = ib; t->ta = ta; t->tb = tb;
    t->stageP = stageP; t->tc_all = tc_all;
    t->e0 = e0; t->e1 = e1; t->tC = tC; t->tD = tD;
    t->stage_off = stage_off;
}

long vn_imdct_batch(
    const float *spec, long B, int n, const float *T,
    const int32_t *ia, const int32_t *ib, const int32_t *ta,
    const int32_t *tb, const float *sa, const float *sb,
    const int32_t *stageP, const int64_t *stage_off, int nstages,
    const int32_t *tc_all,
    const int32_t *e0, const int32_t *e1, const int32_t *tC,
    const int32_t *tD,
    float *out, float *y /* scratch, n/2 floats */)
{
    vn_imtab t;
    vn_imtab_init(&t, n, T, ia, ib, ta, tb, sa, sb, stageP, stage_off,
                  nstages, tc_all, e0, e1, tC, tD);
    for (long f = 0; f < B; f++)
        vn_imdct1(&t, spec + (long)f * (n >> 1), out + (long)f * n, y);
    return 0;
}

/* Windowed lapped overlap-add (the decode side's block.c
 * vorbis_synthesis_blockin composition): each block multiplies its
 * hybrid window and scatter-adds at its center-aligned offset.  Same
 * per-sample multiply/add order as the batched numpy path ->
 * bit-identical output. */
long vn_lap_add(const float *blocksL, const float *blocksS,
                int ch, int n1, int n0, long npkt,
                const int32_t *which, const int32_t *idx,
                const int32_t *winid, const int64_t *offs,
                const float *wins, const int64_t *win_off,
                float *out, long outlen)
{
    for (long p = 0; p < npkt; p++) {
        int n = which[p] ? n1 : n0;
        const float *b = which[p]
            ? blocksL + (long)idx[p] * ch * n1
            : blocksS + (long)idx[p] * ch * n0;
        const float *w = wins + win_off[winid[p]];
        long o = offs[p];
        for (int c = 0; c < ch; c++) {
            float *d = out + (long)c * outlen + o;
            const float *s = b + (long)c * n;
            for (int i = 0; i < n; i++)
                d[i] += s[i] * w[i];
        }
    }
    return 0;
}

/* ===================================================================
 * Frame-tiled IMDCT: the SAME per-frame expression trees as
 * vn_imdct_batch above, evaluated for VNL independent frames at a
 * time in a lane-major layout (element i of lane l lives at
 * [i*VNL + l]).  Each frame's operations keep their exact order, so
 * the output is bit-identical to the scalar kernel — the lane loop
 * only interleaves INDEPENDENT frames, which is what lets the
 * compiler turn every butterfly statement into one AVX-512 vector op
 * (the scalar kernel's gather-indexed loads defeat vectorization
 * within a single frame).
 */

#define VNL 16

static void vn_bf8_l(float *x)
{
    for (int l = 0; l < VNL; l++) {
        float r0 = x[6*VNL+l] + x[2*VNL+l], r1 = x[6*VNL+l] - x[2*VNL+l];
        float r2 = x[4*VNL+l] + x[0*VNL+l], r3 = x[4*VNL+l] - x[0*VNL+l];
        float n6 = r0 + r2, n4 = r0 - r2;
        float s0 = x[5*VNL+l] - x[1*VNL+l], s2 = x[7*VNL+l] - x[3*VNL+l];
        float n0 = r1 + s0, n2 = r1 - s0;
        float u0 = x[5*VNL+l] + x[1*VNL+l], u1 = x[7*VNL+l] + x[3*VNL+l];
        float n3 = s2 + r3, n1 = s2 - r3;
        float n7 = u1 + u0, n5 = u1 - u0;
        x[0*VNL+l] = n0; x[1*VNL+l] = n1; x[2*VNL+l] = n2;
        x[3*VNL+l] = n3; x[4*VNL+l] = n4; x[5*VNL+l] = n5;
        x[6*VNL+l] = n6; x[7*VNL+l] = n7;
    }
}

static void vn_bf16_l(float *x)
{
    const float c2 = VN_cPI2_8;
    for (int l = 0; l < VNL; l++) {
        float r0 = x[1*VNL+l] - x[9*VNL+l], r1 = x[0*VNL+l] - x[8*VNL+l];
        float n8 = x[8*VNL+l] + x[0*VNL+l], n9 = x[9*VNL+l] + x[1*VNL+l];
        float n0 = (r0 + r1) * c2, n1 = (r0 - r1) * c2;
        float r0b = x[3*VNL+l] - x[11*VNL+l],
              r1b = x[10*VNL+l] - x[2*VNL+l];
        float n10 = x[10*VNL+l] + x[2*VNL+l],
              n11 = x[11*VNL+l] + x[3*VNL+l];
        float n2 = r0b, n3 = r1b;
        float r0c = x[12*VNL+l] - x[4*VNL+l],
              r1c = x[13*VNL+l] - x[5*VNL+l];
        float n12 = x[12*VNL+l] + x[4*VNL+l],
              n13 = x[13*VNL+l] + x[5*VNL+l];
        float n4 = (r0c - r1c) * c2, n5 = (r0c + r1c) * c2;
        float r0d = x[14*VNL+l] - x[6*VNL+l],
              r1d = x[15*VNL+l] - x[7*VNL+l];
        float n14 = x[14*VNL+l] + x[6*VNL+l],
              n15 = x[15*VNL+l] + x[7*VNL+l];
        float n6 = r0d, n7 = r1d;
        x[0*VNL+l] = n0; x[1*VNL+l] = n1; x[2*VNL+l] = n2;
        x[3*VNL+l] = n3; x[4*VNL+l] = n4; x[5*VNL+l] = n5;
        x[6*VNL+l] = n6; x[7*VNL+l] = n7;
        x[8*VNL+l] = n8; x[9*VNL+l] = n9; x[10*VNL+l] = n10;
        x[11*VNL+l] = n11; x[12*VNL+l] = n12; x[13*VNL+l] = n13;
        x[14*VNL+l] = n14; x[15*VNL+l] = n15;
    }
    vn_bf8_l(x);
    vn_bf8_l(x + 8*VNL);
}

static void vn_bf32_l(float *x)
{
    const float c1 = VN_cPI1_8, c2 = VN_cPI2_8, c3 = VN_cPI3_8;
    for (int l = 0; l < VNL; l++) {
        float r0 = x[30*VNL+l] - x[14*VNL+l],
              r1 = x[31*VNL+l] - x[15*VNL+l];
        float n30 = x[30*VNL+l] + x[14*VNL+l],
              n31 = x[31*VNL+l] + x[15*VNL+l];
        float n14 = r0, n15 = r1;
        float r0b = x[28*VNL+l] - x[12*VNL+l],
              r1b = x[29*VNL+l] - x[13*VNL+l];
        float n28 = x[28*VNL+l] + x[12*VNL+l],
              n29 = x[29*VNL+l] + x[13*VNL+l];
        float n12 = r0b * c1 - r1b * c3, n13 = r0b * c3 + r1b * c1;
        float r0c = x[26*VNL+l] - x[10*VNL+l],
              r1c = x[27*VNL+l] - x[11*VNL+l];
        float n26 = x[26*VNL+l] + x[10*VNL+l],
              n27 = x[27*VNL+l] + x[11*VNL+l];
        float n10 = (r0c - r1c) * c2, n11 = (r0c + r1c) * c2;
        float r0d = x[24*VNL+l] - x[8*VNL+l],
              r1d = x[25*VNL+l] - x[9*VNL+l];
        float n24 = x[24*VNL+l] + x[8*VNL+l],
              n25 = x[25*VNL+l] + x[9*VNL+l];
        float n8 = r0d * c3 - r1d * c1, n9 = r1d * c3 + r0d * c1;
        float r0e = x[22*VNL+l] - x[6*VNL+l],
              r1e = x[7*VNL+l] - x[23*VNL+l];
        float n22 = x[22*VNL+l] + x[6*VNL+l],
              n23 = x[23*VNL+l] + x[7*VNL+l];
        float n6 = r1e, n7 = r0e;
        float r0f = x[4*VNL+l] - x[20*VNL+l],
              r1f = x[5*VNL+l] - x[21*VNL+l];
        float n20 = x[20*VNL+l] + x[4*VNL+l],
              n21 = x[21*VNL+l] + x[5*VNL+l];
        float n4 = r1f * c1 + r0f * c3, n5 = r1f * c3 - r0f * c1;
        float r0g = x[2*VNL+l] - x[18*VNL+l],
              r1g = x[3*VNL+l] - x[19*VNL+l];
        float n18 = x[18*VNL+l] + x[2*VNL+l],
              n19 = x[19*VNL+l] + x[3*VNL+l];
        float n2 = (r1g + r0g) * c2, n3 = (r1g - r0g) * c2;
        float r0h = x[0*VNL+l] - x[16*VNL+l],
              r1h = x[1*VNL+l] - x[17*VNL+l];
        float n16 = x[16*VNL+l] + x[0*VNL+l],
              n17 = x[17*VNL+l] + x[1*VNL+l];
        float n0 = r1h * c3 + r0h * c1, n1 = r1h * c1 - r0h * c3;
        x[0*VNL+l] = n0; x[1*VNL+l] = n1; x[2*VNL+l] = n2;
        x[3*VNL+l] = n3; x[4*VNL+l] = n4; x[5*VNL+l] = n5;
        x[6*VNL+l] = n6; x[7*VNL+l] = n7; x[8*VNL+l] = n8;
        x[9*VNL+l] = n9; x[10*VNL+l] = n10; x[11*VNL+l] = n11;
        x[12*VNL+l] = n12; x[13*VNL+l] = n13; x[14*VNL+l] = n14;
        x[15*VNL+l] = n15; x[16*VNL+l] = n16; x[17*VNL+l] = n17;
        x[18*VNL+l] = n18; x[19*VNL+l] = n19; x[20*VNL+l] = n20;
        x[21*VNL+l] = n21; x[22*VNL+l] = n22; x[23*VNL+l] = n23;
        x[24*VNL+l] = n24; x[25*VNL+l] = n25; x[26*VNL+l] = n26;
        x[27*VNL+l] = n27; x[28*VNL+l] = n28; x[29*VNL+l] = n29;
        x[30*VNL+l] = n30; x[31*VNL+l] = n31;
    }
    vn_bf16_l(x);
    vn_bf16_l(x + 16*VNL);
}

/* Full tile of VNL frames from per-lane row pointers.  scratch:
 * (3*n2)*VNL floats (xT | yT | zT).  win == NULL: plain frame-major
 * stores to dst[l] (the vn_imdct_batch16 contract).  win != NULL:
 * the symmetric expansion is FUSED with the windowed lapped
 * overlap-add — dst[l][i] += o_i * win[l][i] — which is bitwise
 * identical to storing o and running vn_lap_add afterwards (same
 * multiply-then-add per sample; float addition into the accumulator
 * is commutative, and every output sample receives contributions from
 * at most the two adjacent blocks). */
static void vn_imdct16_rows(const vn_imtab *t, const float **rows,
                            float *scratch, float **dst,
                            const float **win)
{
    int n = t->n;
    int n2 = n >> 1, n4 = n >> 2, n8 = n >> 3;
    const float *T = t->T, *sa = t->sa, *sb = t->sb;
    const int32_t *ia = t->ia, *ib = t->ib, *ta = t->ta, *tb = t->tb;
    const int32_t *stageP = t->stageP;
    const int64_t *stage_off = t->stage_off;
    int nstages = t->nstages;
    const int32_t *tc_all = t->tc_all;
    const int32_t *e0 = t->e0, *e1 = t->e1, *tC = t->tC, *tD = t->tD;
    float *xT = scratch;
    float *yT = scratch + (long)n2 * VNL;
    float *zT = scratch + 2L * n2 * VNL;
    {
        /* transpose in: lane-major tile */
        for (int l = 0; l < VNL; l++) {
            const float *x = rows[l];
            for (int i = 0; i < n2; i++)
                xT[(long)i * VNL + l] = x[i];
        }

        /* stage A: pre-rotation (same association order:
         * (sa*x)*T + (sb*x)*T) */
        for (int i = 0; i < n2; i++) {
            const float sav = sa[i], sbv = sb[i];
            const float tav = T[ta[i]], tbv = T[tb[i]];
            const float *pa = xT + (long)ia[i] * VNL;
            const float *pb = xT + (long)ib[i] * VNL;
            float *py = yT + (long)i * VNL;
            for (int l = 0; l < VNL; l++)
                py[l] = sav * pa[l] * tav + sbv * pb[l] * tbv;
        }

        /* stage B: radix-2 cascade */
        for (int s = 0; s < nstages; s++) {
            int P = stageP[s];
            const int32_t *tc = tc_all + stage_off[s];
            int half = P >> 1, nc = P >> 2;
            for (int b = 0; b < n2 / P; b++) {
                float *lo = yT + (long)b * P * VNL;
                float *hi = lo + (long)half * VNL;
                for (int m = 0; m < nc; m++) {
                    const float c = T[tc[m]], sn = T[tc[m] + 1];
                    float *h0 = hi + (2L * m) * VNL;
                    float *h1 = h0 + VNL;
                    float *l0 = lo + (2L * m) * VNL;
                    float *l1 = l0 + VNL;
                    for (int l = 0; l < VNL; l++) {
                        float hv0 = h0[l], hv1 = h1[l];
                        float lv0 = l0[l], lv1 = l1[l];
                        float r0 = hv0 - lv0, r1 = hv1 - lv1;
                        h0[l] = hv0 + lv0;
                        h1[l] = hv1 + lv1;
                        l0[l] = r1 * sn + r0 * c;
                        l1[l] = r1 * c - r0 * sn;
                    }
                }
            }
        }
        for (int b = 0; b < n2 / 32; b++)
            vn_bf32_l(yT + (long)b * 32 * VNL);

        /* stage C: bitreverse + half-angle rotation into zT */
        for (int m = 0; m < n8; m++) {
            const float c = T[tC[m]], sn = T[tC[m] + 1];
            const float *pa = yT + (long)e0[m] * VNL;
            const float *pb = yT + (long)e1[m] * VNL;
            float *q0 = zT + (2L * m) * VNL;
            float *q1 = q0 + VNL;
            float *q2 = zT + ((long)n4 + 2 * (n8 - 1 - m)) * VNL;
            float *q3 = q2 + VNL;
            for (int l = 0; l < VNL; l++) {
                float a0 = pa[l], a1 = pa[VNL + l];
                float b0 = pb[l], b1 = pb[VNL + l];
                float r0 = a1 - b1, r1 = a0 + b0;
                float r2 = r1 * c + r0 * sn;
                float r3 = r1 * sn - r0 * c;
                float r0h = 0.5f * (a1 + b1);
                float r1h = 0.5f * (a0 - b0);
                q0[l] = r0h + r2;
                q1[l] = r1h + r3;
                q2[l] = r0h - r2;
                q3[l] = r3 - r1h;
            }
        }

        /* stage D: final rotation (a into yT[0:n4], b into
         * yT[n4:n2]) */
        for (int i = 0; i < n4; i++) {
            const float c = T[tD[i]], sn = T[tD[i] + 1];
            const float *pz = zT + (2L * i) * VNL;
            float *pA = yT + (long)i * VNL;
            float *pB = yT + ((long)n4 + i) * VNL;
            for (int l = 0; l < VNL; l++) {
                float z0 = pz[l], z1 = pz[VNL + l];
                pA[l] = z0 * sn - z1 * c;
                pB[l] = -(z0 * c + z1 * sn);
            }
        }

        /* symmetric expansion, transposing back to frame-major */
        for (int l = 0; l < VNL; l++) {
            float *o = dst[l];
            if (win) {
                const float *w = win[l];
                for (int i = 0; i < n4; i++) {
                    o[i] += yT[(long)(n4 - 1 - i) * VNL + l] * w[i];
                    o[n4 + i] += (-yT[(long)i * VNL + l]) * w[n4 + i];
                    o[n2 + i] += yT[((long)n4 + (n4 - 1 - i)) * VNL + l]
                        * w[n2 + i];
                    o[n2 + n4 + i] += yT[((long)n4 + i) * VNL + l]
                        * w[n2 + n4 + i];
                }
            } else {
                for (int i = 0; i < n4; i++) {
                    o[i] = yT[(long)(n4 - 1 - i) * VNL + l];
                    o[n4 + i] = -yT[(long)i * VNL + l];
                    o[n2 + i] = yT[((long)n4 + (n4 - 1 - i)) * VNL + l];
                    o[n2 + n4 + i] = yT[((long)n4 + i) * VNL + l];
                }
            }
        }
    }
}

/* Full-tile IMDCT of VNL frames.  scratch: (3*n2)*VNL floats
 * (xT | yT | zT).  Frames B must be a multiple of VNL — the Python
 * caller routes the remainder through vn_imdct_batch. */
long vn_imdct_batch16(
    const float *spec, long B, int n, const float *T,
    const int32_t *ia, const int32_t *ib, const int32_t *ta,
    const int32_t *tb, const float *sa, const float *sb,
    const int32_t *stageP, const int64_t *stage_off, int nstages,
    const int32_t *tc_all,
    const int32_t *e0, const int32_t *e1, const int32_t *tC,
    const int32_t *tD,
    float *out, float *scratch)
{
    vn_imtab t;
    const float *rows[VNL];
    float *dst[VNL];
    int n2 = n >> 1;
    vn_imtab_init(&t, n, T, ia, ib, ta, tb, sa, sb, stageP, stage_off,
                  nstages, tc_all, e0, e1, tC, tD);
    for (long f0 = 0; f0 + VNL <= B; f0 += VNL) {
        for (int l = 0; l < VNL; l++) {
            rows[l] = spec + (f0 + l) * (long)n2;
            dst[l] = out + (f0 + l) * (long)n;
        }
        vn_imdct16_rows(&t, rows, scratch, dst, 0);
    }
    return 0;
}

/* ===================================================================
 * Fused whole-stream decode + native Ogg layer.
 *
 * vn_decode_stream runs the ENTIRE per-stream decode drain in one
 * call, chunked for cache locality: parse CH packets into an
 * L2-resident residue scratch (vn_parse_one), IMDCT each packet's
 * channels through the 16-lane frame-tiled kernel with the windowed
 * lapped overlap-add FUSED into the symmetric expansion, remainder
 * frames through the scalar kernel.  Compared to the staged drain
 * (whole-stream residue/block arrays materialized between stages)
 * this touches ~100x less intermediate memory per stream.
 * Bit-exactness: identical per-packet expression trees; see
 * vn_imdct16_rows on scatter-add order.
 */

#include <stdlib.h>

/* Read just the W (blockflag) of every packet — the Python caller
 * needs the block schedule (output offsets, windows) before the fused
 * call.  out_W[p] = -1 for bad/non-audio packets. */
long vn_scan_W(const uint8_t *data, const int64_t *pkt_off,
               const int64_t *pkt_bits, long npkt, int modebits,
               int nmodes, const int32_t *mode_blockflag,
               int32_t *out_W)
{
    for (long p = 0; p < npkt; p++) {
        const uint8_t *pd = data + pkt_off[p];
        long nbits = pkt_bits[p];
        long pos = 0;
        out_W[p] = -1;
        if (rd_bits(pd, nbits, &pos, 1) != 0)
            continue;
        long mode = rd_bits(pd, nbits, &pos, modebits);
        if (mode < 0 || mode >= nmodes)
            continue;
        int W = mode_blockflag[mode];
        if (W && rd_bits(pd, nbits, &pos, 2) < 0)
            continue;
        out_W[p] = W;
    }
    return 0;
}

long vn_decode_stream(
    const uint8_t *data, const int64_t *pkt_off, const int64_t *pkt_bits,
    long npkt, int ch, int modebits, int nmodes, int nmaps, int submax,
    const int32_t *mode_blockflag, const int32_t *mode_map,
    const int32_t *map_submaps, const int32_t *map_chmux,
    const int32_t *map_floorsub, const int32_t *map_ressub,
    const int32_t *cpl_count, const int32_t *cpl_mag,
    const int32_t *cpl_ang, int maxcpl,
    const int32_t *t1_all, const int32_t *sec_all,
    const int64_t *soff_all, const int64_t *book_secbase,
    const int64_t *book_soffbase, const int32_t *book_K2,
    const float *vals_all, const int64_t *book_valbase,
    const int32_t *book_dim, int nbooks,
    const int32_t *flcfg, const int64_t *flcfg_off,
    const int32_t *rescfg, const int64_t *rescfg_off,
    const float *fromdB, int bs0, int bs1,
    int Pmax, int n2max, int pwmax,
    /* schedule (from vn_scan_W + host prefix sums) */
    const int64_t *offs,          /* per-packet output sample offset */
    const int32_t *winid,         /* per-packet window id (0..7) */
    const float *wins,            /* concatenated hybrid windows */
    const int64_t *win_off,       /* 8 offsets into wins */
    /* imdct tables (short then long block size) */
    const vn_imtab *tab0, const vn_imtab *tab1,
    /* output */
    float *out, long outlen,
    int32_t *out_W,               /* npkt */
    int CH)                       /* chunk packets (cache tile) */
{
    vn_book books[512];
    vn_pctx cx;
    if (vn_pctx_init(&cx, books, ch, modebits, nmodes, nmaps, submax,
                     mode_blockflag, mode_map, map_submaps, map_chmux,
                     map_floorsub, map_ressub, cpl_count, cpl_mag,
                     cpl_ang, maxcpl, t1_all, sec_all, soff_all,
                     book_secbase, book_soffbase, book_K2, vals_all,
                     book_valbase, book_dim, nbooks, flcfg, flcfg_off,
                     rescfg, rescfg_off, fromdB, bs0, bs1,
                     Pmax, n2max, pwmax) < 0)
        return -1;
    if (CH < 1)
        CH = 128;
    {
        long lanes_cap = (long)CH * ch;
        float *res = malloc((size_t)CH * ch * n2max * sizeof(float));
        int32_t *posts = malloc((size_t)CH * ch * Pmax
                                * sizeof(int32_t));
        uint8_t *nz = malloc((size_t)CH * ch);
        int32_t *mode_s = malloc((size_t)CH * sizeof(int32_t));
        int32_t *pword = malloc((size_t)ch * pwmax * sizeof(int32_t));
        const float **rows = malloc(lanes_cap * sizeof(float *));
        float **dst = malloc(lanes_cap * sizeof(float *));
        const float **win = malloc(lanes_cap * sizeof(float *));
        long n2b = bs1 > bs0 ? bs1 : bs0;
        float *imsc = malloc((size_t)3 * (n2b / 2) * VNL
                             * sizeof(float));
        float *ybuf = malloc((size_t)(n2b / 2) * sizeof(float));
        float *obuf = malloc((size_t)n2b * sizeof(float));
        if (!res || !posts || !nz || !mode_s || !pword || !rows
            || !dst || !win || !imsc || !ybuf || !obuf) {
            free(res); free(posts); free(nz); free(mode_s);
            free(pword); free(rows); free(dst); free(win);
            free(imsc); free(ybuf); free(obuf);
            return -2;
        }
        for (long p0 = 0; p0 < npkt; p0 += CH) {
            long p1 = p0 + CH < npkt ? p0 + CH : npkt;
            for (long p = p0; p < p1; p++)
                vn_parse_one(&cx, data + pkt_off[p], pkt_bits[p],
                             out_W + p, mode_s + (p - p0),
                             posts + (p - p0) * (long)ch * Pmax,
                             nz + (p - p0) * (long)ch,
                             res + (p - p0) * (long)ch * n2max,
                             pword);
            for (int Wv = 0; Wv < 2; Wv++) {
                const vn_imtab *t = Wv ? tab1 : tab0;
                int n = Wv ? bs1 : bs0;
                long k = 0;
                for (long p = p0; p < p1; p++) {
                    if (out_W[p] != Wv)
                        continue;
                    for (int c = 0; c < ch; c++) {
                        rows[k] = res
                            + ((p - p0) * (long)ch + c) * n2max;
                        dst[k] = out + (long)c * outlen + offs[p];
                        win[k] = wins + win_off[winid[p]];
                        k++;
                    }
                }
                {
                    long kt = (k / VNL) * VNL;
                    for (long o = 0; o < kt; o += VNL)
                        vn_imdct16_rows(t, rows + o, imsc, dst + o,
                                        win + o);
                    for (long l = kt; l < k; l++) {
                        vn_imdct1(t, rows[l], obuf, ybuf);
                        {
                            float *d = dst[l];
                            const float *w = win[l];
                            for (int i = 0; i < n; i++)
                                d[i] += obuf[i] * w[i];
                        }
                    }
                }
            }
        }
        free(res); free(posts); free(nz); free(mode_s); free(pword);
        free(rows); free(dst); free(win); free(imsc); free(ybuf);
        free(obuf);
    }
    return 0;
}

/* -------------------------------------------------------------------
 * Native Ogg physical-layer scan: pages -> packets in ONE call.
 *
 * Mirrors bitstream/oggfile.py OggStreamReader._scan + .packets()
 * exactly: capture-pattern search with 1-byte resync on damage, CRC
 * check per page (field zeroed), first-BOS serial selection, lacing
 * reassembly with the same hole semantics for orphan continuation
 * segments.  Every packet's bytes are memcpy'd into `blob` (cap >=
 * total stream bytes + 8 slack) so downstream consumers read one
 * dense buffer + offsets — the vn_parse_packets /
 * vn_decode_stream input contract.
 *
 * Returns the packet count (<= maxpkt; -1 on overflow).  serial_io:
 * pass -1 to auto-select the first BOS serial (written back).
 */
long vn_ogg_scan(const uint8_t *data, long n, int64_t *serial_io,
                 uint8_t *blob,
                 int64_t *off, int64_t *len, int64_t *gp,
                 uint8_t *eos, long maxpkt)
{
    long pos = 0;
    long npkt = 0;
    long blob_pos = 0;
    long cur_start = 0;       /* current partial packet start in blob */
    long cur_len = 0;
    int have_partial = 0;
    int64_t serial = *serial_io;
    while (pos + 27 <= n) {
        /* find capture pattern */
        while (pos + 27 <= n
               && !(data[pos] == 'O' && data[pos + 1] == 'g'
                    && data[pos + 2] == 'g' && data[pos + 3] == 'S'))
            pos++;
        if (pos + 27 > n)
            break;
        {
            int version = data[pos + 4];
            int htype = data[pos + 5];
            uint64_t gpu = 0;
            uint32_t pserial = 0, crc_want = 0;
            int nsegs;
            long body_len = 0, total;
            for (int k = 7; k >= 0; k--)
                gpu = (gpu << 8) | data[pos + 6 + k];
            for (int k = 3; k >= 0; k--)
                pserial = (pserial << 8) | data[pos + 14 + k];
            for (int k = 3; k >= 0; k--)
                crc_want = (crc_want << 8) | data[pos + 22 + k];
            nsegs = data[pos + 26];
            if (version != 0 || pos + 27 + nsegs > n) {
                pos++;
                continue;
            }
            for (int s = 0; s < nsegs; s++)
                body_len += data[pos + 27 + s];
            total = 27 + nsegs + body_len;
            if (pos + total > n) {
                pos++;
                continue;
            }
            /* CRC with the crc field zeroed */
            {
                uint32_t crc = (uint32_t)vn_ogg_crc(data + pos, 22, 0);
                uint8_t z[4] = {0, 0, 0, 0};
                crc = (uint32_t)vn_ogg_crc(z, 4, crc);
                crc = (uint32_t)vn_ogg_crc(data + pos + 26, total - 26,
                                           crc);
                if (crc != crc_want) {
                    pos++;
                    continue;
                }
            }
            if (serial < 0 && (htype & 2))       /* first BOS */
                serial = (int64_t)pserial;
            if (serial < 0 || (int64_t)pserial != serial) {
                pos += total;
                continue;
            }
            {
                const uint8_t *lacing = data + pos + 27;
                const uint8_t *body = lacing + nsegs;
                long bo = 0;
                int s0 = 0;
                long last_done = -1;     /* last pkt completed here */
                if ((htype & 1) && !have_partial) {
                    /* hole: drop continuation segments we can't
                     * complete (and their terminator) */
                    while (s0 < nsegs && lacing[s0] == 255) {
                        bo += 255;
                        s0++;
                    }
                    if (s0 < nsegs) {
                        bo += lacing[s0];
                        s0++;
                    }
                    cur_start = blob_pos;
                    cur_len = 0;
                }
                for (int s = s0; s < nsegs; s++) {
                    int l = lacing[s];
                    memcpy(blob + cur_start + cur_len, body + bo,
                           (size_t)l);
                    cur_len += l;
                    bo += l;
                    if (l < 255) {
                        if (npkt >= maxpkt)
                            return -1;
                        off[npkt] = cur_start;
                        len[npkt] = cur_len;
                        gp[npkt] = -1;
                        eos[npkt] = 0;
                        last_done = npkt;
                        npkt++;
                        cur_start += cur_len;
                        cur_len = 0;
                    }
                }
                blob_pos = cur_start + cur_len;
                have_partial = cur_len > 0
                    || (nsegs > 0 && lacing[nsegs - 1] == 255);
                if (last_done >= 0) {
                    gp[last_done] = (int64_t)gpu;
                    eos[last_done] = (htype & 4) ? 1 : 0;
                }
            }
            pos += total;
        }
    }
    *serial_io = serial;
    return npkt;
}
