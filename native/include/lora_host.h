/* C API of the native host-side runtime for gr_lora_tpu.
 *
 * The GPU (JAX/XLA) owns the signal-processing compute; this library owns
 * the packet-rate host paths around it, mirroring what the reference keeps
 * in C++ (bit-level codec: encode_impl.cc/decode_impl.cc; stream buffering:
 * the GNU Radio runtime's ring buffers).  Exposed as a flat C ABI for
 * ctypes binding.
 */

#ifndef GR_LORA_TPU_LORA_HOST_H
#define GR_LORA_TPU_LORA_HOST_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
  int32_t sf;              /* 6..12 */
  int32_t cr;              /* 1..4 */
  int32_t crc;             /* bool */
  int32_t ldr;             /* bool */
  int32_t explicit_header; /* bool */
  int32_t payload_len;     /* implicit-header payload bytes */
} lora_params;

/* Total symbols per packet incl. the 8 header symbols
 * (reference: encode_impl.cc:107-112). */
int32_t lora_calc_sym_num(const lora_params* prm, int32_t payload_len);

/* payload -> chirp-bin symbols.  Returns symbol count, or -1 on bad args,
 * -2 if out_cap is too small. */
int32_t lora_encode(const lora_params* prm, const uint8_t* payload,
                    int32_t payload_len, uint16_t* out_syms, int32_t out_cap);

/* chirp-bin symbols -> bytes (header bytes + payload + CRC bytes + 1
 * pass/fail byte, exactly the reference PDU, decode_impl.cc:406-413).
 * Returns byte count; -1 invalid header, -2 short packet, -3 out_cap too
 * small.  hdr_* and crc_ok may be NULL. */
int32_t lora_decode(const lora_params* prm, const uint16_t* syms,
                    int32_t nsym, uint8_t* out, int32_t out_cap,
                    int32_t* hdr_valid, int32_t* hdr_payload_len,
                    int32_t* hdr_cr, int32_t* hdr_crc, int32_t* crc_ok);

/* CRC16 with the reference's XOR-last-two-bytes quirk (utilities.h:74-94). */
uint16_t lora_data_checksum(const uint8_t* data, int32_t len);

/* 5-bit explicit-header checksum (utilities.h:96-120). */
uint8_t lora_header_checksum(uint8_t payload_len, uint8_t cr_crc);

/* The 255-byte whitening sequence (lora.h:29-30); dst must hold 255. */
void lora_whitening_sequence(uint8_t* dst);

/* ---- Pyramid peak-track / packet state machine (host fast path;
 * behavior-identical to models/pyramid.PyramidTracker). ---- */
typedef struct lora_pyramid lora_pyramid;

/* grace: consecutive idle hops a preamble-length track may survive
 * (0 = exact reference behavior).  split_repeats: split merged
 * adjacent-equal-symbol tracks into per-symbol data peaks (opt-in,
 * beyond-reference; twin of models/pyramid.py split_repeats). */
/* quantize_round: 1 = rounded bin->symbol assembly (product default);
 * 0 = bit-true reference floor rule (pyramid_demod_impl.cc:744). */
lora_pyramid* lora_pyramid_create(int32_t sf, int32_t p, int32_t fft_factor,
                                  int32_t ldr, float threshold,
                                  int32_t grace, int32_t split_repeats,
                                  int32_t quantize_round);
void lora_pyramid_destroy(lora_pyramid* t);
/* Feed one hop's extracted peaks, sorted ascending by bin (pass npeaks=0
 * for an empty hop). */
void lora_pyramid_step(lora_pyramid* t, const int32_t* bins, const float* h,
                       const float* h_single, int32_t npeaks);
int32_t lora_pyramid_pending(const lora_pyramid* t);
/* Pop one finished packet's symbols; returns count, -1 empty, -2 cap. */
int32_t lora_pyramid_pop(lora_pyramid* t, uint16_t* dst, int32_t cap);
/* As pop, also yielding the packet's preamble timestamp (sample index mod
 * 2^28; ts may be NULL). */
int32_t lora_pyramid_pop_ts(lora_pyramid* t, uint16_t* dst, int32_t cap,
                            int64_t* ts);
/* Empty hops needed to retire all tracks and expire all TTLs. */
int32_t lora_pyramid_flush_hops(const lora_pyramid* t);
/* Graceful-degradation counters: {tracks_dropped, packets_dropped,
 * tracks_overflow_finalized}.  The reference exit(-1)s on pool exhaustion
 * (pyramid_demod_impl.cc:256-260); we drop + count instead. */
void lora_pyramid_stats(const lora_pyramid* t, int64_t* out3);

/* ---- Multi-channel tracker bank: C independent trackers advanced from one
 * batched [C, H, M] peak-lattice block per call (gateway-scale path). ---- */
typedef struct lora_pyramid_multi lora_pyramid_multi;

lora_pyramid_multi* lora_pyramid_multi_create(int32_t channels, int32_t sf,
                                              int32_t p, int32_t fft_factor,
                                              int32_t ldr, float threshold,
                                              int32_t grace,
                                              int32_t split_repeats,
                                              int32_t quantize_round);
void lora_pyramid_multi_destroy(lora_pyramid_multi* m);
/* bins/h/h_single float32/int32 [C, H, M] row-major, valid uint8 [C, H, M];
 * advances every channel tracker by H hops. */
void lora_pyramid_multi_feed(lora_pyramid_multi* m, const int32_t* bins,
                             const float* h, const float* h_single,
                             const uint8_t* valid, int32_t channels,
                             int32_t hops, int32_t max_peaks);
int32_t lora_pyramid_multi_pending(const lora_pyramid_multi* m,
                                   int32_t channel);
int32_t lora_pyramid_multi_pop(lora_pyramid_multi* m, int32_t channel,
                               uint16_t* dst, int32_t cap);
int32_t lora_pyramid_multi_pop_ts(lora_pyramid_multi* m, int32_t channel,
                                  uint16_t* dst, int32_t cap, int64_t* ts);
int32_t lora_pyramid_multi_flush_hops(const lora_pyramid_multi* m);
void lora_pyramid_multi_stats(const lora_pyramid_multi* m, int64_t* out3);

/* ---- SPSC lock-free ring buffer (GR stream-buffer analog). ---- */
typedef struct lora_ring lora_ring;

lora_ring* lora_ring_create(size_t capacity_bytes);
void lora_ring_destroy(lora_ring* rb);
size_t lora_ring_capacity(const lora_ring* rb);
size_t lora_ring_readable(const lora_ring* rb);
size_t lora_ring_writable(const lora_ring* rb);
/* Both return the number of bytes actually moved (partial on full/empty). */
size_t lora_ring_write(lora_ring* rb, const uint8_t* data, size_t n);
size_t lora_ring_read(lora_ring* rb, uint8_t* out, size_t n);
/* Copy without consuming (for overlap-save history windows). */
size_t lora_ring_peek(const lora_ring* rb, uint8_t* out, size_t n);

#ifdef __cplusplus
}
#endif

#endif /* GR_LORA_TPU_LORA_HOST_H */
