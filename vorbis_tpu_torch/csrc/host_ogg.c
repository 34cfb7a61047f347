/* Host C of the port: the Ogg page CRC, the one-call audio pager, the
 * stretch-rescue walk and the blockout schedule.
 *
 * Copies of vn_ogg_crc (native/vorbisnative.c:138-156), vn_ogg_pages
 * (:187-272), vn_rescue_walk (:2046-2078) and vn_schedule (:2088-2160),
 * so that the port's Ogg paging (vorbis_tpu_torch/bitstream/oggfile.py
 * ogg_crc, models/fastenc.py _page_stream), envelope rescue
 * (models/fastenc.py _rescue_walk_batch) and block scheduling
 * (models/fastenc.py _schedule) need no library of the JAX package.  Built at first use by
 * vorbis_tpu_torch/native.py with `cc -O3 -fPIC -shared` and bound with
 * ctypes; the entry points have plain C linkage.
 *
 * Ogg page CRC: poly 0x04c11db7, non-reflected, init/xorout 0
 * (reference: libogg crc_lookup usage in ogg_page_checksum_set). */

#include <stdint.h>
#include <string.h>

#ifdef __cplusplus
extern "C" {
#endif

uint32_t vtt_ogg_crc(const uint8_t *data, long n, uint32_t crc)
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
    return crc;
}

/* Emit one stream's audio packets as Ogg pages in one pass.  Packet i's
 * bytes are (isshort[i] ? pk_s + ilk[i]*ws : pk_l + ilk[i]*wl) (row
 * index times row width, or width 1 and a byte offset), sizes[i] (bytes),
 * gps[i] (granulepos of the page ENDING at packet i).  Page fill mirrors
 * the reference Ogg encode loop (<= per_page packets, lacing table <= 255
 * segments), header layout per the Ogg spec, CRC as above.  Returns the
 * bytes written to out (the caller sizes out as
 * sum(sizes) + npkt*(27+255)); *pageno_io advances past the emitted
 * pages. */
long vtt_ogg_pages(const uint8_t *pk_l, long wl, const uint8_t *pk_s,
                   long ws, const int64_t *ilk, const uint8_t *isshort,
                   const int64_t *sizes, const int64_t *gps, long npkt,
                   uint32_t serialno, int per_page, int eos_last,
                   uint8_t *out, int64_t *pageno_io)
{
    long pageno = (long)*pageno_io;
    long o = 0;
    long i0 = 0;
    while (i0 < npkt) {
        long hi = i0;
        int nseg = 0;
        long body = 0;
        while (hi < npkt && hi - i0 < per_page) {
            long nsz = sizes[hi];
            int need = (int)(nsz / 255 + 1);
            if (nseg && nseg + need > 255)
                break;
            nseg += need;
            body += nsz;
            hi++;
        }
        int eos = eos_last && hi == npkt;
        uint8_t *h = out + o;
        h[0] = 'O'; h[1] = 'g'; h[2] = 'g'; h[3] = 'S';
        h[4] = 0;
        h[5] = (uint8_t)(eos ? 4 : 0);
        int64_t gp = gps[hi - 1];
        for (int k = 0; k < 8; k++)
            h[6 + k] = (uint8_t)((uint64_t)gp >> (8 * k));
        for (int k = 0; k < 4; k++)
            h[14 + k] = (uint8_t)(serialno >> (8 * k));
        for (int k = 0; k < 4; k++)
            h[18 + k] = (uint8_t)((uint32_t)pageno >> (8 * k));
        h[22] = h[23] = h[24] = h[25] = 0;
        h[26] = (uint8_t)nseg;
        long lo = o + 27;
        for (long i = i0; i < hi; i++) {
            long nsz = sizes[i];
            while (nsz >= 255) {
                out[lo++] = 255;
                nsz -= 255;
            }
            out[lo++] = (uint8_t)nsz;
        }
        for (long i = i0; i < hi; i++) {
            const uint8_t *src = isshort[i]
                ? pk_s + ilk[i] * ws : pk_l + ilk[i] * wl;
            memcpy(out + lo, src, (size_t)sizes[i]);
            lo += sizes[i];
        }
        uint32_t crc = vtt_ogg_crc(out + o, lo - o, 0);
        for (int k = 0; k < 4; k++)
            h[22 + k] = (uint8_t)(crc >> (8 * k));
        o = lo;
        pageno++;
        i0 = hi;
    }
    *pageno_io = pageno;
    return o;
}

/* Stretch-rescue lockstep walk (the serial half of the fast encoder's
 * envelope rescue; reference state machine: envelope.c:569-681
 * _ve_envelope_search).  T1/T2 are device-built boolean trigger
 * tables, shape (smax/2 + 1, C, Lw) C-order, indexed
 * [stretch>>1, cluster, window step]; wlen[c] is cluster c's live
 * window length.  Writes newmk (C, Lw+2) and retrig (C,), both
 * zeroed by the caller.  The per-step feedback (stretch resets to -1
 * on a pre-echo trigger, saturates at smax) is the only serial state,
 * so the walk is a table scan. */
long vtt_rescue_walk(const uint8_t *T1, const uint8_t *T2,
                     long C, long Lw, const int32_t *wlen, int smax,
                     uint8_t *newmk, uint8_t *retrig)
{
    long c, k;
    for (c = 0; c < C; c++) {
        const long wl = wlen[c];
        uint8_t *nm = newmk + c * (Lw + 2);
        int stretch = smax;
        int rt = 0;
        for (k = 0; k < wl; k++) {
            long s2;
            uint8_t t1, t2;
            stretch = stretch + 1 < smax ? stretch + 1 : smax;
            s2 = (long)(stretch >> 1);
            t1 = T1[(s2 * C + c) * Lw + k];
            t2 = T2[(s2 * C + c) * Lw + k];
            if (t1 | t2)
                nm[k] = 1;
            if (t1)
                nm[k + 1] = 1;
            if (t2 && k > 0)
                nm[k - 1] = 1;
            if (t1) {
                if (k >= wl - (smax + 2))
                    rt = 1;
                stretch = -1;
            }
        }
        retrig[c] = (uint8_t)rt;
    }
    return 0;
}

/* Envelope marks -> block schedule: the exact blockout /
 * envelope_search state machine (reference: block.c:557-812 W
 * feedback, envelope.c:569-735 cursor/curmark semantics), one serial
 * pass.  marks: (nmk,) uint8; emits centers (i64), Ws (i64), impulse
 * (u8) in padded-stream coordinates.  Returns the segment count (the
 * caller sizes the outputs to (end_c - hop)/(n0/2) + 3). */
long vtt_schedule(const uint8_t *marks, long nmk, long ns,
                  long n0, long n1,
                  int64_t *centers, int64_t *Ws, uint8_t *impulse)
{
    const long hop = n1 / 2;
    const long end_c = hop + ns;
    const long limit = 64 * nmk;
    const long bs[2] = { n0, n1 };
    long centerW = hop;
    long W = 0;
    long cursor = hop;
    long curmark = 0;
    long mi0 = 0;          /* first mark index with pos >= cursor */
    long cnt = 0;

    /* cursor and centerW are monotone, so both scans below only ever
     * move forward */
    for (;;) {
        long testW = centerW + bs[W] / 4 + n1 / 2 + n0 / 4;
        long m_abs = -1;
        long mi, bp, nW, imp;
        /* advance mi0 to the first mark at/after cursor */
        while (mi0 < nmk
               && (!marks[mi0] || (int64_t)mi0 * 64 < cursor))
            mi0++;
        /* first mark strictly after centerW */
        mi = mi0;
        while (mi < nmk) {
            if (marks[mi] && (int64_t)mi * 64 > centerW) {
                m_abs = (int64_t)mi * 64;
                break;
            }
            mi++;
        }
        if (m_abs >= 0 && m_abs < testW) {
            bp = 0;
            cursor = m_abs;
            curmark = m_abs;
        } else if (testW <= limit) {
            bp = 1;
            if (((testW - 1) / 64) * 64 > cursor)
                cursor = ((testW - 1) / 64) * 64;
        } else {
            bp = -1;
            if (((limit - 1) / 64) * 64 > cursor)
                cursor = ((limit - 1) / 64) * 64;
        }
        nW = bp == 1 ? 1 : 0;
        imp = 0;
        if (W == 0) {
            long b0 = centerW - n0 / 4 - n0 / 4;
            long e0 = centerW + n0 / 4 + n0 / 4;
            long b = b0 <= 0 ? 0 : b0 / 64;
            long e = e0 <= 0 ? 0 : (e0 + 63) / 64;
            long i;
            if (b > nmk) b = nmk;
            if (e > nmk) e = nmk;
            for (i = b; i < e; i++) {
                if (marks[i]) { imp = 1; break; }
            }
            if (!imp && b0 <= curmark && curmark < e0 && curmark > 0)
                imp = 1;
        }
        centers[cnt] = centerW;
        Ws[cnt] = W;
        impulse[cnt] = (uint8_t)imp;
        cnt++;
        if (centerW >= end_c)
            break;
        centerW = centerW + bs[W] / 4 + bs[nW] / 4;
        W = nW;
    }
    return cnt;
}

#ifdef __cplusplus
}
#endif
