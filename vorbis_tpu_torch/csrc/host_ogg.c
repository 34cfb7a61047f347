/* Host C of the port: the Ogg page CRC.
 *
 * Copy of vn_ogg_crc (native/vorbisnative.c:138-156), so that the port's
 * Ogg paging (vorbis_tpu_torch/bitstream/oggfile.py ogg_crc) needs no
 * library of the JAX package.  Built at first use by
 * vorbis_tpu_torch/native.py with `cc -O3 -fPIC -shared` and bound with
 * ctypes; the entry point has plain C linkage.
 *
 * Ogg page CRC: poly 0x04c11db7, non-reflected, init/xorout 0
 * (reference: libogg crc_lookup usage in ogg_page_checksum_set). */

#include <stdint.h>

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

#ifdef __cplusplus
}
#endif
