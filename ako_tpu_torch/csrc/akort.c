/*
ako_tpu_torch native runtime: the port's own copy of ako_tpu's
ako_tpu/runtime/native/akort.c (the same code, but for
akort_kagari_sync, which jumps RLE runs and counts what it jumped; its
records and failures are the same; and akort_kagari_sync_tiles, which
scans an image's tiles in one call on native threads), so that the port
builds and changes it without reading a file of the JAX package.
runtime/build.py compiles it and binds the functions the port calls.

Sequential host-side pieces of the codec.

 1. The quantization / noise-gate exponential curve. It is defined over
    libm float32 ops (sqrtf/log2f/powf/roundf), so the only way to be
    bit-exact with the reference (library/quantization.c:43-97) is to
    evaluate it with the very same libm. Inputs are tiny and discrete;
    Python callers cache results per (tile, level, factor).

 2. The "Kagari" entropy coder: Elias-gamma codes (unary length prefix +
    binary value, MSB-first into a 64-bit accumulator) over a
    zigzag-mapped int16 stream with a run-length escape after two
    repeats. Behavioral contract from library/kagari.c:59-366, written
    fresh here: byte-exact output including the accumulator flush
    pattern, buffer-bound failure conditions, the RLE trigger/overflow
    rules, and the uint16 truncation quirk for zigzag(-32768)+1.

The wavelet/color/quantization compute path lives on the device; this
file is only the host bitstream tail (and its curve twin), plus a CPU
golden path used by tests and as the port's oracle.

Build: cc -O2 -pthread -fPIC -shared akort.c -lm -o _akort.so (see
runtime/build.py).
*/

#include <math.h>
#include <pthread.h>
#include <stdatomic.h>
#include <stddef.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>
#include <sys/syscall.h>
#include <time.h>
#include <unistd.h>

#define API __attribute__((visibility("default")))

/* ------------------------------------------------------------------ */
/* Quantization / gate curve                                           */

static float expo_curve(float factor, float tile_w, float tile_h, float cur_w,
                        float cur_h)
{
	const float root_area0 = sqrtf(tile_w * tile_h);
	const float root_area = sqrtf(cur_w * cur_h);
	const float lifts_total = log2f(root_area0) - 1.0f;
	const float lift_cur = log2f(root_area) - 1.0f;

	/* "highs first" tuning: degrade the high-frequency (large) levels
	   harder; exponent 6, scale 512*0.73 */
	const float linear = lift_cur / lifts_total;
	const float degrade = powf(linear + 1.0f, 6.0f) / powf(2.0f, 6.0f);

	const float base = powf(2.0f, lift_cur - 1.0f) * degrade;
	return roundf(base * (factor / (512.0f * 0.73f)));
}

API int32_t akort_quantization(int32_t factor, int32_t factor_mul, uint64_t tile_w,
                               uint64_t tile_h, uint64_t cur_w, uint64_t cur_h)
{
	if (factor <= 0)
		return 1;
	float q = expo_curve((float)factor * (float)factor_mul, (float)tile_w,
	                     (float)tile_h, (float)cur_w, (float)cur_h);
	if (q < 1.0f)
		q = 1.0f;
	if (q > 32765.0f)
		q = 32765.0f;
	return (int32_t)(int16_t)q;
}

API int32_t akort_gate(int32_t factor, int32_t factor_mul, uint64_t tile_w,
                       uint64_t tile_h, uint64_t cur_w, uint64_t cur_h)
{
	if (factor <= 0)
		return 0;
	float g = expo_curve((float)factor * (float)factor_mul, (float)tile_w,
	                     (float)tile_h, (float)cur_w, (float)cur_h);
	if (g < 0.0f)
		g = 0.0f;
	if (g > 32765.0f)
		g = 32765.0f;
	return (int32_t)(int16_t)g;
}

/* ------------------------------------------------------------------ */
/* Elias-gamma bit sink / source                                       */

#define ACC_BITS 64
#define REFILL_THRESHOLD 32
#define RLE_TRIGGER 2
#define VALUE_MAX 65535

typedef struct {
	uint64_t acc;
	int used; /* bits currently held */
	uint8_t *pos;
	const uint8_t *lim;
} BitSink;

typedef struct {
	uint64_t acc;
	int used;
	const uint8_t *pos;
	const uint8_t *lim;
} BitSource;

static int gamma_bits(uint16_t v)
{
	/* floor(log2(v)) via clz; v == 0 (the zigzag(-32768)+1 wrap) and
	   v == 1 both code in 1 bit, exactly like the shift loop */
	const int b = v > 1 ? 31 - __builtin_clz(v) : 0;
	return b * 2 + 1;
}

/* Append one gamma code; returns bits written, 0 on out-of-space.
   The flush pattern (drain one byte at a time only while the new code
   would not fit, and only once more than 8 bits are buffered) is part
   of the byte-exact contract. */
static int sink_put(BitSink *s, uint16_t v)
{
	const int nbits = gamma_bits(v);

	if (s->used > 8 && s->used + nbits > ACC_BITS) {
		if (s->pos + (s->used / 8) >= s->lim)
			return 0;
		do {
			s->used -= 8;
			*s->pos++ = (uint8_t)(s->acc >> s->used);
		} while (s->used + nbits > ACC_BITS);
	}

	s->used += nbits;
	s->acc = (s->acc << nbits) | (uint64_t)v;
	return nbits;
}

/* Drain whole bytes then the zero-padded partial byte; returns total
   stream size in bytes from `start`, 0 on out-of-space. */
static size_t sink_finish(BitSink *s, const uint8_t *start)
{
	while (s->used / 8 != 0) {
		if (s->pos + 1 >= s->lim)
			return 0;
		s->used -= 8;
		*s->pos++ = (uint8_t)(s->acc >> s->used);
	}
	if (s->used != 0) {
		if (s->pos + 1 >= s->lim)
			return 0;
		*s->pos++ = (uint8_t)(s->acc << (8 - s->used));
	}
	return (size_t)(s->pos - start);
}

/* Read one gamma code; 0 return with *bits_out==0 means failure. */
/* always_inline: one call per decoded symbol — the call overhead
   alone was ~10% of kagari_decode (devbench/time_tile.c A/B); inlining
   also lets the struct fields live in registers across the loop */
__attribute__((always_inline)) static inline uint16_t
source_get(BitSource *s, int *bits_out)
{
	if (s->acc == 0 || s->used < (ACC_BITS - REFILL_THRESHOLD)) {
		/* plain while loops: entering with used > 56 (possible only on
		   corrupt input, via acc == 0) must not shift by a negative
		   count — reading nothing falls through to the acc == 0 check */
		if (s->used < (ACC_BITS - 8) && s->pos + 8 <= s->lim) {
			/* bulk refill: one unaligned big-endian load supplies
			   the exact bytes the byte loop would have appended
			   (top (56-used)-rounded-up bits of the window, OR'd
			   below the `used` bits already held) */
			uint64_t w;
			memcpy(&w, s->pos, 8);
			w = __builtin_bswap64(w);
			const int nbytes = (ACC_BITS - 1 - s->used) / 8;
			w &= ~0ull << (ACC_BITS - 8 * nbytes);
			s->acc |= w >> s->used;
			s->used += 8 * nbytes;
			s->pos += nbytes;
		} else if (s->pos + ((ACC_BITS - s->used) / 8) < s->lim) {
			while (s->used < (ACC_BITS - 8)) {
				s->used += 8;
				s->acc |= (uint64_t)(*s->pos++) << (ACC_BITS - s->used);
			}
		} else {
			while (s->used < (ACC_BITS - 8) && s->pos < s->lim) {
				s->used += 8;
				s->acc |= (uint64_t)(*s->pos++) << (ACC_BITS - s->used);
			}
		}
		if (s->acc == 0)
			return 0;
	}

	const uint32_t top = (uint32_t)(s->acc >> REFILL_THRESHOLD);
	const int unary = (top == 0) ? 32 : __builtin_clz(top);
	const int nbits = unary * 2 + 1;

	if (nbits > s->used)
		return 0;

	*bits_out = nbits;
	const uint16_t v = (uint16_t)(s->acc >> (ACC_BITS - nbits));
	s->acc <<= nbits;
	s->used -= nbits;
	return v;
}

/* ------------------------------------------------------------------ */
/* Kagari stream layer: zigzag literals + RLE escapes                  */

static uint16_t zigzag16(int16_t v)
{
	/* shift the UNSIGNED reinterpretation: <<1 on a negative int is
	   UB in C (same value bits on every sane target, but UBSan-clean
	   matters for a parser fed untrusted input) */
	return (uint16_t)(((uint32_t)(uint16_t)v << 1) ^
	                  (uint32_t)(uint16_t)((int16_t)v >> 15));
}

static int16_t unzigzag16(uint16_t u)
{
	return (int16_t)((u >> 1) ^ (uint16_t)(0u - (u & 1u)));
}

/* Fast-path Kagari encoder: same token sequence and same emitted
   bytes as the exact sink below, but drains ALL whole accumulator
   bytes with one unaligned 8-byte store per flush (~1 flush per ~13
   codes on the bench distribution) instead of the reference's
   minimal byte-at-a-time dance, and checks capacity only at flush
   granularity. Bit-concatenation is associative, so the flush
   schedule never changes the output bytes — only the FAILURE
   boundary is schedule-dependent, and that is the reference contract
   (kagari.c's akoEliasEncodeStep). So this path only reports success
   when the result provably fits with >= 2 bytes to spare (the exact
   sink can overshoot payload size by at most pos + used/8 <=
   ceil(B/8) + 1 mid-stream); anything tighter returns the NEAR_CAP
   sentinel and the caller re-runs the exact encoder to decide. */
#define KAGARI_FAST_NEAR_CAP ((size_t)-1)

static inline int fast_put(uint64_t *acc, int *used, uint8_t **pos,
                           const uint8_t *guard, uint16_t v)
{
	const int nbits = gamma_bits(v);
	if (*used + nbits > ACC_BITS) {
		if (*pos >= guard)
			return 0;
		const int k = *used >> 3;
		uint64_t w = __builtin_bswap64(*acc << (ACC_BITS - *used));
		memcpy(*pos, &w, 8); /* k valid bytes + scratch tail */
		*pos += k;
		*used -= k << 3;
	}
	*used += nbits;
	*acc = (*acc << nbits) | (uint64_t)v;
	return 1;
}

static size_t kagari_encode_fast(const int16_t *in, const int16_t *in_lim,
                                 uint8_t *out, size_t output_size)
{
	/* guard leaves room for the 8-byte scratch store AND the final
	   <= 8 pending bytes; trips -> exact re-run */
	if (output_size < 32)
		return KAGARI_FAST_NEAR_CAP;
	uint8_t *pos = out;
	const uint8_t *const guard = out + output_size - 16;
	uint64_t acc = 0;
	int used = 0;

	if (!fast_put(&acc, &used, &pos, guard, (uint16_t)(zigzag16(*in) + 1)))
		return KAGARI_FAST_NEAR_CAP;
	int16_t prev = *in++;

	while (in < in_lim) {
		if (*in != prev) {
			if (!fast_put(&acc, &used, &pos, guard,
			              (uint16_t)(zigzag16(*in) + 1)))
				return KAGARI_FAST_NEAR_CAP;
			prev = *in++;
			continue;
		}
		size_t L = 1;
		while (in + L < in_lim && in[L] == prev)
			L++;
		in += L;
		const uint16_t zz = (uint16_t)(zigzag16(prev) + 1);
		while (L != 0) {
			const size_t lits = L < RLE_TRIGGER ? L : RLE_TRIGGER;
			for (size_t i = 0; i < lits; i++)
				if (!fast_put(&acc, &used, &pos, guard, zz))
					return KAGARI_FAST_NEAR_CAP;
			L -= lits;
			const size_t cap = (size_t)(VALUE_MAX - 1 - RLE_TRIGGER);
			const size_t chunk = L < cap ? L : cap;
			L -= chunk;
			if (lits == RLE_TRIGGER) {
				/* chunk+1 also covers the forced-flush case:
				 * chunk==cap gives VALUE_MAX-1-RLE_TRIGGER+1
				 * == cap+1 (the exact coder keeps the branch
				 * pair for the reference's comment trail) */
				const uint16_t tok = (uint16_t)(chunk + 1);
				if (!fast_put(&acc, &used, &pos, guard, tok))
					return KAGARI_FAST_NEAR_CAP;
			}
		}
	}
	/* drain pending: whole bytes then the zero-padded partial */
	while (used >= 8) {
		used -= 8;
		*pos++ = (uint8_t)(acc >> used);
	}
	if (used != 0)
		*pos++ = (uint8_t)(acc << (8 - used));
	const size_t n = (size_t)(pos - out);
	/* success only when the exact sink provably also succeeds */
	if (n + 2 > output_size)
		return KAGARI_FAST_NEAR_CAP;
	return n;
}

API size_t akort_kagari_encode(const void *input, size_t input_size, void *output,
                               size_t output_size)
{
	const int16_t *in = (const int16_t *)input;
	const int16_t *const in_lim = (const int16_t *)((const uint8_t *)input + input_size);

	BitSink sink = {0, 0, (uint8_t *)output, (const uint8_t *)output + output_size};

	if (output_size == 0 || input_size == 0 || (input_size % 2) != 0)
		return 0;

	{
		/* bulk-drain fast path; NEAR_CAP (can't prove the exact
		   sink's verdict) falls through to the exact encoder */
		const size_t fast = kagari_encode_fast(in, in_lim,
		                                       (uint8_t *)output,
		                                       output_size);
		if (fast != KAGARI_FAST_NEAR_CAP)
			return fast;
	}

	/* literal = gamma(zigzag(v) + 1); the +1 wraps to 0 for v == -32768,
	   matching the reference's uint16 argument truncation */
	if (sink_put(&sink, (uint16_t)(zigzag16(*in) + 1)) == 0)
		return 0;

	int16_t prev = *in++;

	/* Runs are scanned ahead in one tight (vectorizable) compare loop
	   and their emissions replayed in bulk — the token sequence is
	   IDENTICAL to the reference's per-value counter walk
	   (kagari.c:260-297): literals for counter 1..RLE_TRIGGER, silence
	   until the forced flush at counter 65534 (token 65533, counter
	   reset, cycle repeats), and an end-of-run token counter-2+1 when
	   the counter sits >= RLE_TRIGGER at the mismatch/stream end. */
	while (in < in_lim) {
		if (*in != prev) {
			if (sink_put(&sink, (uint16_t)(zigzag16(*in) + 1)) == 0)
				return 0;
			prev = *in++;
			continue;
		}
		size_t L = 1;
		while (in + L < in_lim && in[L] == prev)
			L++;
		in += L;
		const uint16_t zz = (uint16_t)(zigzag16(prev) + 1);
		while (L != 0) {
			const size_t lits = L < RLE_TRIGGER ? L : RLE_TRIGGER;
			for (size_t i = 0; i < lits; i++)
				if (sink_put(&sink, zz) == 0)
					return 0;
			L -= lits;
			const size_t cap = (size_t)(VALUE_MAX - 1 - RLE_TRIGGER);
			const size_t chunk = L < cap ? L : cap;
			L -= chunk;
			if (lits == RLE_TRIGGER) {
				/* both arms emit chunk+1 (cap+1 == VALUE_MAX-1-RLE_TRIGGER+1);
				 * the branch is kept only to mirror the exact encoder's
				 * comment trail for the two flush reasons */
				if (chunk == cap) {
					/* forced flush at counter 65534 */
					if (sink_put(&sink,
					             (uint16_t)(VALUE_MAX - 1 - RLE_TRIGGER + 1)) == 0)
						return 0;
				} else {
					/* run ended: token = counter - trigger + 1 */
					if (sink_put(&sink, (uint16_t)(chunk + 1)) == 0)
						return 0;
				}
			}
		}
	}

	return sink_finish(&sink, (const uint8_t *)output);
}

/* Kagari decode as an explicit per-symbol state machine: kd_step is
   EXACTLY one iteration of the reference decode loop (top-of-loop
   out_lim check, branchless literal/run merge, rare RLE-trigger
   branch, count-- at iteration end), so a calling loop over one KD
   reproduces akort_kagari_decode bit-for-bit — and TWO interleaved
   KDs overlap their serial refill->clz->shift dependency chains
   (measured 1.29x over back-to-back decodes; the span decoder pairs
   tiles this way). */
typedef struct {
	BitSource src;
	const uint8_t *base;
	int16_t *out;
	const int16_t *out_lim;
	size_t count;
	int16_t prev;
	uint32_t run;
	int state; /* 0 running, 1 done, -1 broken */
} KD;

static inline int kd_init(KD *s, size_t count, const void *input,
                          size_t input_size, void *output,
                          size_t output_size)
{
	s->src.acc = 0;
	s->src.used = 0;
	s->src.pos = (const uint8_t *)input;
	s->src.lim = (const uint8_t *)input + input_size;
	s->base = (const uint8_t *)input;
	s->out = (int16_t *)output;
	s->out_lim = (const int16_t *)((uint8_t *)output + output_size);
	s->run = 0;
	s->count = count;
	s->state = -1;
	if (output_size == 0 || input_size == 0 || count == 0 ||
	    (output_size % 2) != 0)
		return 0;
	int bits = 0;
	const uint16_t u = source_get(&s->src, &bits);
	if (bits == 0)
		return 0;
	s->prev = unzigzag16((uint16_t)(u - 1));
	*s->out++ = s->prev;
	s->count--;
	s->state = s->count == 0 ? 1 : 0;
	return 1;
}

static inline void kd_step(KD *s)
{
	if (s->out == s->out_lim) {
		s->state = -1;
		return;
	}
	int bits = 0;
	const uint16_t u = source_get(&s->src, &bits);
	if (bits == 0) {
		s->state = -1;
		return;
	}
	const int16_t v = unzigzag16((uint16_t)(u - 1));

	/* branchless literal/run-count merge: the v==prev compare is
	   data-dependent and mispredict-prone per symbol; fold it to
	   a conditional move and keep only the rare trigger branch */
	*s->out++ = v;
	s->run = (v == s->prev) ? s->run + 1 : 0;
	s->prev = v;
	if (s->run == RLE_TRIGGER) {
		bits = 0;
		const uint16_t rle_raw = source_get(&s->src, &bits);
		if (bits == 0) {
			s->state = -1;
			return;
		}
		const uint16_t rle_len = (uint16_t)(rle_raw - 1);

		if ((s->out + (size_t)rle_len) > s->out_lim) {
			s->state = -1;
			return;
		}
		for (uint16_t i = 0; i < rle_len; i++)
			s->out[i] = s->prev;
		s->out += rle_len;
		s->run = 0;
		s->count -= rle_len; /* may wrap; caught by out_lim check */
	}
	if (--s->count == 0)
		s->state = 1;
}

static inline size_t kd_consumed(const KD *s)
{
	return s->state == 1 ? (size_t)(s->src.pos - s->base) : 0;
}

API size_t akort_kagari_decode(size_t count, const void *input, size_t input_size,
                               void *output, size_t output_size)
{
	KD s;
	if (!kd_init(&s, count, input, input_size, output, output_size))
		return 0;
	while (s.state == 0)
		kd_step(&s);
	return kd_consumed(&s);
}

/* Two independent streams decoded in one interleaved loop: each
   stream's semantics are untouched (same kd_step), but the two serial
   per-symbol dependency chains overlap in the pipeline. Results and
   consumed-byte counts are identical to two akort_kagari_decode
   calls. */
static void kagari_decode_pair(KD *a, KD *b)
{
	while (a->state == 0 && b->state == 0) {
		kd_step(a);
		kd_step(b);
	}
	while (a->state == 0)
		kd_step(a);
	while (b->state == 0)
		kd_step(b);
}

/* ------------------------------------------------------------------ */
/* Sync scan for the device-side parallel decoder                      */

/* consec sentinel: "first output of the stream pending" (the reference
   writes the first literal without any run-comparison, kagari.c:322) */
#define SYNC_FIRST 0xFFFFu

/*
Walk the Kagari stream exactly like akort_kagari_decode, but instead of
writing values, record the decoder state at every `block`-th output
position: (logical bit offset of the next unread code, previous value,
consecutive-equal count, remaining run length). The device decoder then
decodes all blocks in parallel from these sync points, bit-exactly
(ops/kagari_device.py:kagari_decode_device).

The records come from a countdown to the next block boundary: the scan
keeps the output index of its next record and compares its own output
index with it before each code, with no division. An RLE run is jumped:
its length code writes the record of every boundary inside the run (bit
offset after the length code, the run's value, consec 0, the values left
in the run from that boundary) and moves the output index to the run's
end. The scan's cost follows the codes it reads, not the values they
expand to.

The logical bit offset is the sum of consumed code lengths; it is
independent of the byte-granular accumulator readahead. Failure
conditions mirror akort_kagari_decode one-for-one (same BitSource, same
output-capacity checks), so the device path errors exactly when the
host path would (reference kagari.c:301-366).

Returns consumed input bytes (cursor position including readahead, the
same value akort_kagari_decode returns) or 0 on broken input. Writes
ceil(count/block) records, and on success *run_values: the output values
that the scan passed over inside RLE runs.

The one body of both entry points, akort_kagari_sync (one stream) and
akort_kagari_sync_tiles (an image's tiles on native threads).
*/
static size_t kagari_sync_scan(size_t count, const void *input,
                               size_t input_size, size_t output_size,
                               size_t block, uint32_t *bit_off,
                               int16_t *prev_arr, uint16_t *consec_arr,
                               uint16_t *run_arr, uint32_t *max_code_bits,
                               uint64_t *run_values)
{
	BitSource src = {0, 0, (const uint8_t *)input,
	                 (const uint8_t *)input + input_size};

	if (output_size == 0 || input_size == 0 || count == 0 || block == 0 ||
	    (output_size % 2) != 0)
		return 0;

	const size_t out_cap = output_size / 2;
	const size_t n_rec = (count + block - 1) / block;
	size_t no = count;
	size_t out_idx = 0;
	size_t rec = 0;
	size_t next = 0; /* output index of the next record */
	uint64_t jumped = 0;
	uint32_t bitpos = 0;
	uint32_t maxbits = 0;
	int16_t prev = 0;
	uint32_t run = 0;
	int bits = 0;
	uint16_t u;
	int16_t v;

#define SYNC_BITS()                                                       \
	do {                                                                  \
		if ((uint32_t)bits > maxbits)                                     \
			maxbits = (uint32_t)bits;                                     \
	} while (0)

	/* the record at output index `next`; after the n_rec-th, `next`
	   is one no output index reaches */
#define SYNC_EMIT(consec_v, runrem_v)                                     \
	do {                                                                  \
		bit_off[rec] = bitpos;                                            \
		prev_arr[rec] = prev;                                             \
		consec_arr[rec] = (uint16_t)(consec_v);                           \
		run_arr[rec] = (uint16_t)(runrem_v);                              \
		next = ++rec < n_rec ? next + block : SIZE_MAX;                   \
	} while (0)

	/* first value: written without run comparison (kagari.c:322) */
	SYNC_EMIT(SYNC_FIRST, 0);
	u = source_get(&src, &bits);
	if (bits == 0)
		return 0;
	SYNC_BITS();
	bitpos += (uint32_t)bits;
	prev = unzigzag16((uint16_t)(u - 1));
	out_idx++;
	no--;

	for (; no != 0; no--) {
		if (out_idx >= out_cap)
			return 0;
		if (out_idx == next)
			SYNC_EMIT(run, 0);

		bits = 0;
		u = source_get(&src, &bits);
		if (bits == 0)
			return 0;
		SYNC_BITS();
		bitpos += (uint32_t)bits;
		v = unzigzag16((uint16_t)(u - 1));

		if (v == prev) {
			out_idx++;
			run++;
			if (run == RLE_TRIGGER) {
				bits = 0;
				const uint16_t rle_raw = source_get(&src, &bits);
				if (bits == 0)
					return 0;
				SYNC_BITS();
				bitpos += (uint32_t)bits;
				const uint16_t rle_len = (uint16_t)(rle_raw - 1);
				const size_t end = out_idx + (size_t)rle_len;
				if (end > out_cap)
					return 0;
				/* every boundary in [out_idx, end), then jump */
				while (next < end)
					SYNC_EMIT(0, end - next);
				out_idx = end;
				jumped += rle_len;
				run = 0;
				no -= rle_len; /* may wrap; caught by out_cap check */
			}
		} else {
			out_idx++;
			prev = v;
			run = 0;
		}
	}

#undef SYNC_EMIT
#undef SYNC_BITS
	*max_code_bits = maxbits;
	*run_values = jumped;
	return (size_t)(src.pos - (const uint8_t *)input);
}

API size_t akort_kagari_sync(size_t count, const void *input, size_t input_size,
                             size_t output_size, size_t block,
                             uint32_t *bit_off, int16_t *prev_arr,
                             uint16_t *consec_arr, uint16_t *run_arr,
                             uint32_t *max_code_bits, uint64_t *run_values)
{
	return kagari_sync_scan(count, input, input_size, output_size, block,
	                        bit_off, prev_arr, consec_arr, run_arr,
	                        max_code_bits, run_values);
}

/* The sync scans of n tiles whose payloads lie in one blob: tile i's
   payload is blob[pay_off[i], pay_off[i] + pay_size[i]), its `counts[i]`
   values have an output capacity of caps[i] bytes, and its records start
   at rec_off[i] in the four shared record arrays. Per tile it writes
   consumed[i] (0: broken input), max_bits[i] and jumped[i] (0 where
   broken), as akort_kagari_sync returns and writes them; every tile is
   scanned, broken ones too.

   The tiles go to `threads` native threads, made for this call, each
   taking the next unscanned tile from one atomic counter: a tile's cost
   follows its codes, so a static cut would leave threads idle. With one
   tile or one thread the calling thread scans and no thread is made. Given
   t_start, the scan of tile i ran from t_start[i] to t_end[i] (ns on
   CLOCK_REALTIME, time.time_ns()'s clock) on thread tid[i] (gettid()).

   Returns the number of threads that scanned: fewer than asked where the
   system refused a thread (the others scan its share). */
typedef struct {
	const uint8_t *blob;
	const int64_t *pay_off, *pay_size, *counts, *caps, *rec_off;
	size_t block;
	int64_t n;
	_Atomic int64_t next;
	uint32_t *bit_off;
	int16_t *prev;
	uint16_t *consec, *run;
	int64_t *consumed;
	uint32_t *max_bits;
	uint64_t *jumped;
	int64_t *t_start, *t_end;
	int32_t *tid;
} SyncTiles;

static int64_t now_ns(void)
{
	struct timespec ts;
	clock_gettime(CLOCK_REALTIME, &ts);
	return (int64_t)ts.tv_sec * 1000000000 + ts.tv_nsec;
}

static void *sync_tiles_worker(void *arg)
{
	SyncTiles *job = (SyncTiles *)arg;
	const int32_t tid = job->t_start ? (int32_t)syscall(SYS_gettid) : 0;
	for (;;) {
		const int64_t i = atomic_fetch_add_explicit(&job->next, 1,
		                                            memory_order_relaxed);
		if (i >= job->n)
			return NULL;
		if (job->t_start)
			job->t_start[i] = now_ns();
		const int64_t r = job->rec_off[i];
		uint32_t maxbits = 0;
		uint64_t jumped = 0;
		const size_t consumed = kagari_sync_scan(
		    (size_t)job->counts[i], job->blob + job->pay_off[i],
		    (size_t)job->pay_size[i], (size_t)job->caps[i], job->block,
		    job->bit_off + r, job->prev + r, job->consec + r,
		    job->run + r, &maxbits, &jumped);
		job->consumed[i] = (int64_t)consumed;
		job->max_bits[i] = consumed ? maxbits : 0;
		job->jumped[i] = consumed ? jumped : 0;
		if (job->t_start) {
			job->t_end[i] = now_ns();
			job->tid[i] = tid;
		}
	}
}

API int32_t akort_kagari_sync_tiles(
    const uint8_t *blob, int64_t n, const int64_t *pay_off,
    const int64_t *pay_size, const int64_t *counts, const int64_t *caps,
    const int64_t *rec_off, int64_t block, int32_t threads,
    uint32_t *bit_off, int16_t *prev, uint16_t *consec, uint16_t *run,
    int64_t *consumed, uint32_t *max_bits, uint64_t *jumped,
    int64_t *t_start, int64_t *t_end, int32_t *tid)
{
	SyncTiles job = {blob, pay_off, pay_size, counts, caps, rec_off,
	                 (size_t)block, n, 0, bit_off, prev, consec, run,
	                 consumed, max_bits, jumped, t_start, t_end, tid};
	if (threads > n)
		threads = (int32_t)n;
	pthread_t *pool = threads > 1
	                      ? (pthread_t *)malloc(sizeof(pthread_t) * threads)
	                      : NULL;
	/* a scan needs little stack: at 256 KiB the C library keeps the
	   stacks of a call's threads for the next call, where its default 8
	   MiB stacks are mapped and unmapped anew past its cache's first few
	   (32 threads over 260 one-value tiles: 5.6 ms with the default
	   stacks, 2.3 ms with these, on the 32-core host of four H100s) */
	pthread_attr_t attr;
	pthread_attr_init(&attr);
	pthread_attr_setstacksize(&attr, 256 << 10);
	int32_t made = 0;
	if (pool != NULL)
		while (made < threads &&
		       pthread_create(&pool[made], &attr, sync_tiles_worker, &job) == 0)
			made++;
	pthread_attr_destroy(&attr);
	if (made == 0) /* one tile, one thread, or no thread to be had */
		sync_tiles_worker(&job);
	for (int32_t k = 0; k < made; k++)
		pthread_join(pool[k], NULL);
	free(pool);
	return made ? made : 1;
}

/* ------------------------------------------------------------------ */
/* Native tile unlift + pixel format: the decode-side compute path on  */
/* the host CPU.                                                       */
/*                                                                     */
/* Semantics contract: ako_tpu/ops/wavelets.py (unlift1d_pair,         */
/* unlift2d), ops/lifting.py (inverse_tile) and ops/colorspace.py      */
/* (to_interleaved_u8) — which are themselves oracle-tested against    */
/* the reference decoder (library/lifting.c:295, wavelet-*.c,          */
/* format.c:244). All arithmetic is int32 with an int16 truncation at  */
/* every coefficient store; C's `/` is the truncating division both    */
/* sides use. Used by the host-decode pipeline path and the transport  */
/* unpack (runtime/hostcodec.py) so decoded pixels never need a        */
/* device round-trip when the host<->device link is the bottleneck.    */

enum { W_DD137 = 0, W_CDF53 = 1, W_HAAR = 2, W_NONE = 3 };
enum { WR_CLAMP = 0, WR_MIRROR = 1, WR_REPEAT = 2, WR_ZERO = 3 };
enum { CL_YCOCG = 0, CL_SUBG = 1, CL_NONE = 2, CL_YCOCG_Q = 3 };

static int32_t half_plus_one(int32_t v)
{
	return (v % 2 == 0) ? v / 2 : (v + 1) / 2;
}

static int eff_wavelet(int wavelet, int32_t tw, int32_t th)
{
	/* sub-8x8 levels always lift CDF53 in DD137 mode
	   (ops/wavelets.py:effective_wavelet) */
	if (wavelet == W_DD137 && (tw < 8 || th < 8))
		return W_CDF53;
	return wavelet;
}

/* 1-D neighbor taps with the per-wrap edge substitutions of
   ops/wavelets.py:_shift_{prev,next}{,2}. n >= 2 always (lift targets
   never go below 2); the +-2 taps only run under DD137, whose levels
   are >= 8 on the lifted axis. */

static inline int32_t tap_m1(const int16_t *x, int n, int i, int wrap)
{
	if (i >= 1)
		return x[i - 1];
	if (wrap == WR_REPEAT)
		return x[n - 1];
	if (wrap == WR_ZERO)
		return 0;
	return x[0]; /* CLAMP and MIRROR share the +-1 edge rule */
}

static inline int32_t tap_p1(const int16_t *x, int n, int i, int wrap)
{
	if (i < n - 1)
		return x[i + 1];
	if (wrap == WR_REPEAT)
		return x[0];
	if (wrap == WR_ZERO)
		return 0;
	return x[n - 1];
}

static inline int32_t tap_m2(const int16_t *x, int n, int i, int wrap)
{
	if (i >= 2)
		return x[i - 2];
	switch (wrap) {
	case WR_CLAMP:
		return x[0];
	case WR_MIRROR:
		return x[i + 1]; /* i=0 -> x[1], i=1 -> x[2] */
	case WR_REPEAT:
		return x[n - 2 + i];
	default:
		return 0;
	}
}

static inline int32_t tap_p2(const int16_t *x, int n, int i, int wrap)
{
	if (i < n - 2)
		return x[i + 2];
	switch (wrap) {
	case WR_CLAMP:
		return x[n - 1];
	case WR_MIRROR:
		return x[i - 1]; /* i=n-2 -> x[n-3], i=n-1 -> x[n-2] */
	case WR_REPEAT:
		return x[i - (n - 2)];
	default:
		return 0;
	}
}

/* Contiguous 1-D inverse pair (the H pass works on rows): evens from
   (lp, hp-neighborhood), then odds from (hp, ev-neighborhood). */
static void unlift_pair_1d(int wavelet, int wrap, const int16_t *lp,
                           const int16_t *hp, int n, int16_t *ev, int16_t *od)
{
	if (wavelet == W_HAAR) {
		for (int i = 0; i < n; i++) {
			ev[i] = lp[i];
			od[i] = (int16_t)((int32_t)lp[i] + (int32_t)hp[i]);
		}
		return;
	}
	if (wavelet == W_CDF53) {
		/* interior peeled off the wrap branches so the truncating
		   divisions vectorize — the inverse twin of lift_pair_1d's
		   peel (same -O3 -march=native auto-vectorization win) */
		ev[0] = (int16_t)((int32_t)lp[0] -
		                  (tap_m1(hp, n, 0, wrap) + (int32_t)hp[0]) / 4);
		for (int i = 1; i < n; i++)
			ev[i] = (int16_t)((int32_t)lp[i] -
			                  ((int32_t)hp[i - 1] + (int32_t)hp[i]) / 4);
		for (int i = 0; i < n - 1; i++)
			od[i] = (int16_t)((int32_t)hp[i] +
			                  ((int32_t)ev[i] + (int32_t)ev[i + 1]) / 2);
		{
			const int i = n - 1;
			od[i] = (int16_t)((int32_t)hp[i] +
			                  ((int32_t)ev[i] + tap_p1(ev, n, i, wrap)) / 2);
		}
		return;
	}
	/* DD137 reaches here only with n >= 8 (eff_wavelet's <8x8 CDF53
	   fallback), so the boundary indices per pass are distinct from
	   the vectorizable interior. The full ev pass completes before od
	   reads it (od taps ev at -1/+1/+2). */
#define UDD_EV(I, M2, M1, P1)                                              \
	ev[I] = (int16_t)((int32_t)lp[I] -                                     \
	                  (-(M2) - (P1) + 9 * ((M1) + (int32_t)hp[I])) / 32)
#define UDD_OD(I, M1, P1, P2)                                              \
	od[I] = (int16_t)((int32_t)hp[I] -                                     \
	                  ((M1) + (P2)-9 * ((int32_t)ev[I] + (P1))) / 16)
	for (int i = 2; i < n - 1; i++)
		UDD_EV(i, (int32_t)hp[i - 2], (int32_t)hp[i - 1], (int32_t)hp[i + 1]);
	UDD_EV(0, tap_m2(hp, n, 0, wrap), tap_m1(hp, n, 0, wrap), (int32_t)hp[1]);
	UDD_EV(1, tap_m2(hp, n, 1, wrap), (int32_t)hp[0], (int32_t)hp[2]);
	UDD_EV(n - 1, (int32_t)hp[n - 3], (int32_t)hp[n - 2],
	       tap_p1(hp, n, n - 1, wrap));
	for (int i = 1; i < n - 2; i++)
		UDD_OD(i, (int32_t)ev[i - 1], (int32_t)ev[i + 1], (int32_t)ev[i + 2]);
	UDD_OD(0, tap_m1(ev, n, 0, wrap), (int32_t)ev[1], (int32_t)ev[2]);
	UDD_OD(n - 2, (int32_t)ev[n - 3], (int32_t)ev[n - 1],
	       tap_p2(ev, n, n - 2, wrap));
	UDD_OD(n - 1, (int32_t)ev[n - 2], tap_p1(ev, n, n - 1, wrap),
	       tap_p2(ev, n, n - 1, wrap));
#undef UDD_EV
#undef UDD_OD
}

/* Row-pointer taps for the V pass (whole rows at a time, so the inner
   loops stay contiguous and auto-vectorizable). `z` is a zeroed row. */
static const int16_t *vrow_m1(const int16_t *x, int th, int tw, int i, int wrap,
                              const int16_t *z)
{
	if (i >= 1)
		return x + (size_t)(i - 1) * tw;
	if (wrap == WR_REPEAT)
		return x + (size_t)(th - 1) * tw;
	if (wrap == WR_ZERO)
		return z;
	return x;
}

static const int16_t *vrow_p1(const int16_t *x, int th, int tw, int i, int wrap,
                              const int16_t *z)
{
	if (i < th - 1)
		return x + (size_t)(i + 1) * tw;
	if (wrap == WR_REPEAT)
		return x;
	if (wrap == WR_ZERO)
		return z;
	return x + (size_t)(th - 1) * tw;
}

static const int16_t *vrow_m2(const int16_t *x, int th, int tw, int i, int wrap,
                              const int16_t *z)
{
	if (i >= 2)
		return x + (size_t)(i - 2) * tw;
	switch (wrap) {
	case WR_CLAMP:
		return x;
	case WR_MIRROR:
		return x + (size_t)(i + 1) * tw;
	case WR_REPEAT:
		return x + (size_t)(th - 2 + i) * tw;
	default:
		return z;
	}
}

static const int16_t *vrow_p2(const int16_t *x, int th, int tw, int i, int wrap,
                              const int16_t *z)
{
	if (i < th - 2)
		return x + (size_t)(i + 2) * tw;
	switch (wrap) {
	case WR_CLAMP:
		return x + (size_t)(th - 1) * tw;
	case WR_MIRROR:
		return x + (size_t)(i - 1) * tw;
	case WR_REPEAT:
		return x + (size_t)(i - (th - 2)) * tw;
	default:
		return z;
	}
}

/* Vertical inverse pair over whole (th x tw) quadrants. */
static void unlift_pair_v(int wavelet, int wrap, const int16_t *lp,
                          const int16_t *hp, int th, int tw, int16_t *ev,
                          int16_t *od, const int16_t *zrow)
{
	if (wavelet == W_HAAR) {
		for (int i = 0; i < th; i++)
			for (int j = 0; j < tw; j++) {
				ev[(size_t)i * tw + j] = lp[(size_t)i * tw + j];
				od[(size_t)i * tw + j] =
				    (int16_t)((int32_t)lp[(size_t)i * tw + j] +
				              (int32_t)hp[(size_t)i * tw + j]);
			}
		return;
	}
	if (wavelet == W_CDF53) {
		for (int i = 0; i < th; i++) {
			const int16_t *l = lp + (size_t)i * tw;
			const int16_t *h0 = hp + (size_t)i * tw;
			const int16_t *hm = vrow_m1(hp, th, tw, i, wrap, zrow);
			int16_t *e = ev + (size_t)i * tw;
			for (int j = 0; j < tw; j++)
				e[j] = (int16_t)((int32_t)l[j] -
				                 ((int32_t)hm[j] + (int32_t)h0[j]) / 4);
		}
		for (int i = 0; i < th; i++) {
			const int16_t *h0 = hp + (size_t)i * tw;
			const int16_t *e0 = ev + (size_t)i * tw;
			const int16_t *ep = vrow_p1(ev, th, tw, i, wrap, zrow);
			int16_t *o = od + (size_t)i * tw;
			for (int j = 0; j < tw; j++)
				o[j] = (int16_t)((int32_t)h0[j] +
				                 ((int32_t)e0[j] + (int32_t)ep[j]) / 2);
		}
		return;
	}
	for (int i = 0; i < th; i++) {
		const int16_t *l = lp + (size_t)i * tw;
		const int16_t *h0 = hp + (size_t)i * tw;
		const int16_t *hm1 = vrow_m1(hp, th, tw, i, wrap, zrow);
		const int16_t *hp1 = vrow_p1(hp, th, tw, i, wrap, zrow);
		const int16_t *hm2 = vrow_m2(hp, th, tw, i, wrap, zrow);
		int16_t *e = ev + (size_t)i * tw;
		for (int j = 0; j < tw; j++)
			e[j] = (int16_t)((int32_t)l[j] -
			                 (-(int32_t)hm2[j] - (int32_t)hp1[j] +
			                  9 * ((int32_t)hm1[j] + (int32_t)h0[j])) /
			                     32);
	}
	for (int i = 0; i < th; i++) {
		const int16_t *h0 = hp + (size_t)i * tw;
		const int16_t *e0 = ev + (size_t)i * tw;
		const int16_t *em1 = vrow_m1(ev, th, tw, i, wrap, zrow);
		const int16_t *ep1 = vrow_p1(ev, th, tw, i, wrap, zrow);
		const int16_t *ep2 = vrow_p2(ev, th, tw, i, wrap, zrow);
		int16_t *o = od + (size_t)i * tw;
		for (int j = 0; j < tw; j++)
			o[j] = (int16_t)((int32_t)h0[j] -
			                 ((int32_t)em1[j] + (int32_t)ep2[j] -
			                  9 * ((int32_t)e0[j] + (int32_t)ep1[j])) /
			                     16);
	}
}

/* One 2-D inverse level: quadrants (th x tw) -> plane
   ((2*th - fake_row) x (2*tw - fake_col)). V pairs first (ll|c and
   b|d), then per-row H merges with even/odd interleave, dropping the
   fabricated last column/row (ops/wavelets.py:unlift2d). */
static void unlift2d_level(int weff, int wrap, const int16_t *ll,
                           const int16_t *b, const int16_t *c,
                           const int16_t *d, int th, int tw, int fake_col,
                           int fake_row, int16_t *out, int16_t *scr)
{
	const int cw = 2 * tw - fake_col;
	const int chh = 2 * th - fake_row;
	int16_t *ev_l = scr;
	int16_t *od_l = ev_l + (size_t)th * tw;
	int16_t *ev_r = od_l + (size_t)th * tw;
	int16_t *od_r = ev_r + (size_t)th * tw;
	int16_t *ev_s = od_r + (size_t)th * tw;
	int16_t *od_s = ev_s + tw;
	int16_t *zrow = od_s + tw; /* pre-zeroed by the caller's calloc */

	unlift_pair_v(weff, wrap, ll, c, th, tw, ev_l, od_l, zrow);
	unlift_pair_v(weff, wrap, b, d, th, tw, ev_r, od_r, zrow);

	for (int i = 0; i < th; i++) {
		unlift_pair_1d(weff, wrap, ev_l + (size_t)i * tw,
		               ev_r + (size_t)i * tw, tw, ev_s, od_s);
		int16_t *orow = out + (size_t)(2 * i) * cw;
		for (int j = 0; j < tw; j++) {
			orow[2 * j] = ev_s[j];
			if (2 * j + 1 < cw)
				orow[2 * j + 1] = od_s[j];
		}
		if (2 * i + 1 < chh) {
			unlift_pair_1d(weff, wrap, od_l + (size_t)i * tw,
			               od_r + (size_t)i * tw, tw, ev_s, od_s);
			orow = out + (size_t)(2 * i + 1) * cw;
			for (int j = 0; j < tw; j++) {
				orow[2 * j] = ev_s[j];
				if (2 * j + 1 < cw)
					orow[2 * j + 1] = od_s[j];
			}
		}
	}
}

/*
Full tile unlift: serialized coefficient stream (the entropy decoder's
output; wire layout of ops/lifting.py — LP planes per channel, then per
level smallest->largest, per channel [int16 q][HP-C][HP-B][HP-D]) ->
planar int16 (channels x tile_h x tile_w). `stream_elems` must equal
tile_data_size(tile_w, tile_h) * channels / 2 (checked). Returns 0 on
success, -1 on argument/size mismatch, -2 on allocation failure.
*/
API int32_t akort_tile_unlift(const int16_t *stream, size_t stream_elems,
                              int32_t tile_w, int32_t tile_h, int32_t channels,
                              int32_t wavelet, int32_t wrap,
                              int16_t *planes_out)
{
	int32_t cur_w[40], cur_h[40], tgt_w[40], tgt_h[40];
	int n_lvl = 0;
	int32_t w = tile_w, h = tile_h;

	if (tile_w < 1 || tile_h < 1 || channels < 1 || stream == NULL ||
	    planes_out == NULL)
		return -1;

	while (w > 2 && h > 2 && n_lvl < 40) {
		cur_w[n_lvl] = w;
		cur_h[n_lvl] = h;
		w = half_plus_one(w);
		h = half_plus_one(h);
		tgt_w[n_lvl] = w;
		tgt_h[n_lvl] = h;
		n_lvl++;
	}
	const size_t lp_n = (size_t)w * h;
	const size_t area = (size_t)tile_w * tile_h;

	if (wavelet == W_NONE || n_lvl == 0) {
		/* raw planar passthrough: the stream IS the planes */
		if (stream_elems != area * (size_t)channels)
			return -1;
		memcpy(planes_out, stream, (size_t)channels * area * 2);
		return 0;
	}

	size_t expect = lp_n;
	for (int k = 0; k < n_lvl; k++)
		expect += 1 + 3 * (size_t)tgt_w[k] * tgt_h[k];
	if (stream_elems != expect * (size_t)channels)
		return -1;

	/* scratch: ping+pong planes, 3 dequantized quadrants, and the
	   unlift2d working set (4 quadrant buffers + 2 rows + zero row),
	   all sized for the largest level */
	const size_t qa = (size_t)tgt_w[0] * tgt_h[0];
	const size_t scr_elems = 4 * qa + 3 * (size_t)tgt_w[0];
	int16_t *mem = (int16_t *)calloc(2 * area + 3 * qa + scr_elems, 2);
	if (mem == NULL)
		return -2;
	int16_t *ping = mem;
	int16_t *pong = ping + area;
	int16_t *dq = pong + area; /* 3 quadrants: C, B, D */
	int16_t *scr = dq + 3 * qa;

	/* per-level chunk base offsets in the stream (levels are serialized
	   smallest first, i.e. k = n_lvl-1 first) */
	size_t base[40];
	size_t off = lp_n * (size_t)channels;
	for (int k = n_lvl - 1; k >= 0; k--) {
		base[k] = off;
		off += (size_t)channels * (1 + 3 * (size_t)tgt_w[k] * tgt_h[k]);
	}

	for (int ch = 0; ch < channels; ch++) {
		int16_t *cur = ping;
		int16_t *nxt = pong;
		memcpy(cur, stream + (size_t)ch * lp_n, lp_n * 2);

		for (int k = n_lvl - 1; k >= 0; k--) {
			const int tw = tgt_w[k], th = tgt_h[k];
			const size_t n = (size_t)tw * th;
			const int16_t *chunk = stream + base[k] + (size_t)ch * (1 + 3 * n);
			const int32_t q = chunk[0];
			const int16_t *src = chunk + 1; /* C then B then D */
			if (q > 1) {
				for (size_t t = 0; t < 3 * n; t++)
					dq[t] = (int16_t)((int32_t)src[t] * q);
			} else {
				memcpy(dq, src, 3 * n * 2);
			}
			const int16_t *qc = dq;
			const int16_t *qb = dq + n;
			const int16_t *qd = dq + 2 * n;
			const int weff = eff_wavelet(wavelet, tw, th);
			/* zero row lives at the tail of scr; re-zero since DD137's
			   tap rows only read, never write, but prior levels share
			   the buffer */
			memset(scr + 4 * n + 2 * tw, 0, (size_t)tw * 2);
			unlift2d_level(weff, wrap, cur, qb, qc, qd, th, tw,
			               2 * tw - cur_w[k], 2 * th - cur_h[k], nxt, scr);
			int16_t *t2 = cur;
			cur = nxt;
			nxt = t2;
		}
		memcpy(planes_out + (size_t)ch * area, cur, area * 2);
	}
	free(mem);
	return 0;
}

static inline uint8_t sat_u8(int32_t v)
{
	return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
}

/*
Inverse color transform + saturation + interleave: planar int16
(channels x h x w) -> interleaved u8 (h x w x channels). Semantics of
ops/colorspace.py:to_interleaved_u8 (reference format.c:244-311):
YCoCg / YCoCg_Q (x2 Y premultiply undone first) / Subtract-Green on the
first three channels when channels >= 3, every channel saturated to
0..255.
*/
/* Inverse twin of u8_to_planes_ycocg: specialized saturating YCoCg
   inverse for the common shapes, vectorizable. */
__attribute__((always_inline)) static inline void
planes_to_u8_ycocg(const int16_t *pl, size_t area, int ch, int qhalf,
                   uint8_t *out)
{
	const int16_t *py = pl, *pu = pl + area, *pv = pl + 2 * area;
	const int16_t *pa = pl + 3 * area;
	for (size_t p = 0; p < area; p++) {
		int32_t y = py[p];
		const int32_t u = pu[p], v = pv[p];
		if (qhalf)
			y = (int16_t)(y / 2);
		const int32_t tmp = (int16_t)(y - v / 2);
		const int32_t g = (int16_t)(v + tmp);
		const int32_t b = (int16_t)(tmp - u / 2);
		const int32_t r = (int16_t)(b + u);
		out[p * ch + 0] = sat_u8(r);
		out[p * ch + 1] = sat_u8(g);
		out[p * ch + 2] = sat_u8(b);
		if (ch == 4)
			out[p * ch + 3] = sat_u8(pa[p]);
	}
}

API void akort_planes_to_u8(const int16_t *planes, int32_t w, int32_t h,
                            int32_t channels, int32_t color, uint8_t *out)
{
	const size_t area = (size_t)w * h;
	const int do_color =
	    channels >= 3 &&
	    (color == CL_YCOCG || color == CL_YCOCG_Q || color == CL_SUBG);

	if (do_color && color != CL_SUBG && (channels == 3 || channels == 4)) {
		const int q = color == CL_YCOCG_Q;
		if (channels == 4 && q)
			planes_to_u8_ycocg(planes, area, 4, 1, out);
		else if (channels == 4)
			planes_to_u8_ycocg(planes, area, 4, 0, out);
		else if (q)
			planes_to_u8_ycocg(planes, area, 3, 1, out);
		else
			planes_to_u8_ycocg(planes, area, 3, 0, out);
		return;
	}

	for (size_t p = 0; p < area; p++) {
		if (do_color) {
			int32_t y = planes[p];
			const int32_t u = planes[area + p];
			const int32_t v = planes[2 * area + p];
			int32_t r, g, b;
			if (color == CL_SUBG) {
				r = (int16_t)(u + y);
				g = (int16_t)y;
				b = (int16_t)(v + y);
			} else {
				if (color == CL_YCOCG_Q)
					y = (int16_t)(y / 2);
				const int32_t tmp = (int16_t)(y - v / 2);
				g = (int16_t)(v + tmp);
				b = (int16_t)(tmp - u / 2);
				r = (int16_t)(b + u);
			}
			out[p * channels + 0] = sat_u8(r);
			out[p * channels + 1] = sat_u8(g);
			out[p * channels + 2] = sat_u8(b);
			for (int32_t c = 3; c < channels; c++)
				out[p * channels + c] = sat_u8(planes[(size_t)c * area + p]);
		} else {
			for (int32_t c = 0; c < channels; c++)
				out[p * channels + c] = sat_u8(planes[(size_t)c * area + p]);
		}
	}
}

/* ------------------------------------------------------------------ */
/* Native forward lift + forward pixel format: the transport packer's  */
/* twin of the unlift above. Semantics: ops/wavelets.py               */
/* lift_core/lift2d, ops/lifting.py forward_tile (fused gate+quantize  */
/* at the highpass store, library/lifting.c:154-168) and               */
/* ops/colorspace.py to_planar_yuv (format.c:64-133). Used by          */
/* runtime/transport.py's encode-side pack (host q0 re-encode of the   */
/* pixel upload) so the pack runs at native speed instead of a         */
/* CPU-XLA forward program. NOT a production encode path — the codec's */
/* encode compute engine is the TPU.                                   */

/* Forward 1-D pair: hp from (odd, even-neighborhood) first, then lp
   from (even, hp-neighborhood). Contiguous (H pass). */
static void lift_pair_1d(int wavelet, int wrap, const int16_t *ev,
                         const int16_t *od, int n, int16_t *lp, int16_t *hp)
{
	if (wavelet == W_HAAR) {
		for (int i = 0; i < n; i++) {
			lp[i] = ev[i];
			hp[i] = (int16_t)((int32_t)od[i] - (int32_t)ev[i]);
		}
		return;
	}
	if (wavelet == W_CDF53) {
		/* interior peeled off the wrap branches so the truncating
		   shift-divisions vectorize (the per-element tap calls were
		   half the forward-lift profile) */
		for (int i = 0; i < n - 1; i++)
			hp[i] = (int16_t)((int32_t)od[i] -
			                  ((int32_t)ev[i] + (int32_t)ev[i + 1]) / 2);
		{
			const int i = n - 1;
			hp[i] = (int16_t)((int32_t)od[i] -
			                  ((int32_t)ev[i] + tap_p1(ev, n, i, wrap)) / 2);
		}
		lp[0] = (int16_t)((int32_t)ev[0] +
		                  (tap_m1(hp, n, 0, wrap) + (int32_t)hp[0]) / 4);
		for (int i = 1; i < n; i++)
			lp[i] = (int16_t)((int32_t)ev[i] +
			                  ((int32_t)hp[i - 1] + (int32_t)hp[i]) / 4);
		return;
	}
	/* DD137 reaches here only with n >= 8 (eff_wavelet's <8x8 CDF53
	   fallback), so the three boundary indices per pass are distinct
	   from the vectorizable interior. */
#define DD_HP(I, M1, P1, P2)                                               \
	hp[I] = (int16_t)((int32_t)od[I] +                                     \
	                  ((M1) + (P2)-9 * ((int32_t)ev[I] + (P1))) / 16)
#define DD_LP(I, M2, M1, P1)                                               \
	lp[I] = (int16_t)((int32_t)ev[I] +                                     \
	                  (-(M2) - (P1) + 9 * ((M1) + (int32_t)hp[I])) / 32)
	for (int i = 1; i < n - 2; i++)
		DD_HP(i, (int32_t)ev[i - 1], (int32_t)ev[i + 1], (int32_t)ev[i + 2]);
	DD_HP(0, tap_m1(ev, n, 0, wrap), (int32_t)ev[1], (int32_t)ev[2]);
	DD_HP(n - 2, (int32_t)ev[n - 3], (int32_t)ev[n - 1],
	      tap_p2(ev, n, n - 2, wrap));
	DD_HP(n - 1, (int32_t)ev[n - 2], tap_p1(ev, n, n - 1, wrap),
	      tap_p2(ev, n, n - 1, wrap));
	for (int i = 2; i < n - 1; i++)
		DD_LP(i, (int32_t)hp[i - 2], (int32_t)hp[i - 1], (int32_t)hp[i + 1]);
	DD_LP(0, tap_m2(hp, n, 0, wrap), tap_m1(hp, n, 0, wrap), (int32_t)hp[1]);
	DD_LP(1, tap_m2(hp, n, 1, wrap), (int32_t)hp[0], (int32_t)hp[2]);
	DD_LP(n - 1, (int32_t)hp[n - 3], (int32_t)hp[n - 2],
	      tap_p1(hp, n, n - 1, wrap));
#undef DD_HP
#undef DD_LP
}

/* Forward V pair over even/odd row streams: ev/od rows live at stride
   `rs` elements (rs == tw for packed halves; rs == 2*tw reads the
   even/odd rows straight out of the H-pass buffer with NO staging
   copies — the vrow helpers take rs as their stride argument, and the
   outputs lp/hp are packed th x tw). */
static void lift_pair_v(int wavelet, int wrap, const int16_t *ev,
                        const int16_t *od, int th, int tw, int rs,
                        int16_t *lp, int16_t *hp, const int16_t *zrow)
{
	if (wavelet == W_HAAR) {
		for (int i = 0; i < th; i++) {
			const int16_t *e0 = ev + (size_t)i * rs;
			const int16_t *o0 = od + (size_t)i * rs;
			int16_t *lrow = lp + (size_t)i * tw;
			int16_t *hrow = hp + (size_t)i * tw;
			for (int j = 0; j < tw; j++) {
				lrow[j] = e0[j];
				hrow[j] = (int16_t)((int32_t)o0[j] - (int32_t)e0[j]);
			}
		}
		return;
	}
	if (wavelet == W_CDF53) {
		for (int i = 0; i < th; i++) {
			const int16_t *e0 = ev + (size_t)i * rs;
			const int16_t *ep = vrow_p1(ev, th, rs, i, wrap, zrow);
			const int16_t *o0 = od + (size_t)i * rs;
			int16_t *hrow = hp + (size_t)i * tw;
			for (int j = 0; j < tw; j++)
				hrow[j] = (int16_t)((int32_t)o0[j] -
				                    ((int32_t)e0[j] + (int32_t)ep[j]) / 2);
		}
		for (int i = 0; i < th; i++) {
			const int16_t *e0 = ev + (size_t)i * rs;
			const int16_t *h0 = hp + (size_t)i * tw;
			const int16_t *hm = vrow_m1(hp, th, tw, i, wrap, zrow);
			int16_t *lrow = lp + (size_t)i * tw;
			for (int j = 0; j < tw; j++)
				lrow[j] = (int16_t)((int32_t)e0[j] +
				                    ((int32_t)hm[j] + (int32_t)h0[j]) / 4);
		}
		return;
	}
	for (int i = 0; i < th; i++) {
		const int16_t *e0 = ev + (size_t)i * rs;
		const int16_t *em1 = vrow_m1(ev, th, rs, i, wrap, zrow);
		const int16_t *ep1 = vrow_p1(ev, th, rs, i, wrap, zrow);
		const int16_t *ep2 = vrow_p2(ev, th, rs, i, wrap, zrow);
		const int16_t *o0 = od + (size_t)i * rs;
		int16_t *hrow = hp + (size_t)i * tw;
		for (int j = 0; j < tw; j++)
			hrow[j] = (int16_t)((int32_t)o0[j] +
			                    ((int32_t)em1[j] + (int32_t)ep2[j] -
			                     9 * ((int32_t)e0[j] + (int32_t)ep1[j])) /
			                        16);
	}
	for (int i = 0; i < th; i++) {
		const int16_t *e0 = ev + (size_t)i * rs;
		const int16_t *h0 = hp + (size_t)i * tw;
		const int16_t *hm1 = vrow_m1(hp, th, tw, i, wrap, zrow);
		const int16_t *hp1 = vrow_p1(hp, th, tw, i, wrap, zrow);
		const int16_t *hm2 = vrow_m2(hp, th, tw, i, wrap, zrow);
		int16_t *lrow = lp + (size_t)i * tw;
		for (int j = 0; j < tw; j++)
			lrow[j] = (int16_t)((int32_t)e0[j] +
			                    (-(int32_t)hm2[j] - (int32_t)hp1[j] +
			                     9 * ((int32_t)hm1[j] + (int32_t)h0[j])) /
			                        32);
	}
}

/* Fused dead-zone gate + truncating quantization at the highpass
   store (lifting.c:154-168): |x| <= g zeroes, else trunc(x/max(q,1)).

   The division uses the Granlund-Montgomery invariant-multiply: with
   m = floor(2^32/d) + 1 and u < 2^16, (u*m) >> 32 == floor(u/d)
   exactly (m*d <= 2^32 + d <= 2^32 + 2^16 satisfies the theorem's
   bound for every d in 2..65536; |x| <= 32768 < 2^16). A runtime-q
   idiv per coefficient was 43% of the whole forward lift profile —
   the multiply form vectorizes. */
static void gate_quant(const int16_t *src, size_t n, int32_t q, int32_t g,
                       int16_t *dst)
{
	const uint32_t qd = (uint32_t)(q < 1 ? 1 : q);
	if (qd == 1) { /* lossless fast path: pure gate */
		for (size_t t = 0; t < n; t++) {
			const int32_t x = src[t];
			dst[t] = (x < -g || x > g) ? (int16_t)x : 0;
		}
		return;
	}
	const uint32_t m = (uint32_t)((((uint64_t)1 << 32) / qd) + 1u);
	for (size_t t = 0; t < n; t++) {
		const int32_t x = src[t];
		const uint32_t ax = (uint32_t)(x < 0 ? -x : x);
		const int32_t qv = (int32_t)(uint32_t)(((uint64_t)ax * m) >> 32);
		const int32_t v = x < 0 ? -qv : qv;
		dst[t] = (x < -g || x > g) ? (int16_t)v : 0;
	}
}

/*
Full forward tile lift: planar int16 (channels x tile_h x tile_w) ->
serialized stream (the exact wire layout akort_tile_unlift consumes).
qs/gs: per-(level, channel) quantization/gate in ENCODE level order
(largest level first, channel-minor) — level_qg's layout flattened
(ops/quantization.py). Returns 0, -1 on bad args/size mismatch, -2 on
allocation failure.
*/
API int32_t akort_tile_lift(const int16_t *planes, int32_t tile_w,
                            int32_t tile_h, int32_t channels, int32_t wavelet,
                            int32_t wrap, const int32_t *qs, const int32_t *gs,
                            int16_t *stream_out, size_t stream_elems)
{
	int32_t cur_w[40], cur_h[40], tgt_w[40], tgt_h[40];
	int n_lvl = 0;
	int32_t w = tile_w, h = tile_h;

	if (tile_w < 1 || tile_h < 1 || channels < 1 || planes == NULL ||
	    stream_out == NULL)
		return -1;

	while (w > 2 && h > 2 && n_lvl < 40) {
		cur_w[n_lvl] = w;
		cur_h[n_lvl] = h;
		w = half_plus_one(w);
		h = half_plus_one(h);
		tgt_w[n_lvl] = w;
		tgt_h[n_lvl] = h;
		n_lvl++;
	}
	const size_t lp_n = (size_t)w * h;
	const size_t area = (size_t)tile_w * tile_h;

	if (wavelet == W_NONE || n_lvl == 0) {
		if (stream_elems != area * (size_t)channels)
			return -1;
		memcpy(stream_out, planes, (size_t)channels * area * 2);
		return 0;
	}

	size_t expect = lp_n;
	for (int k = 0; k < n_lvl; k++)
		expect += 1 + 3 * (size_t)tgt_w[k] * tgt_h[k];
	if (stream_elems != expect * (size_t)channels)
		return -1;

	/* serialized chunk bases: smallest level (k = n_lvl-1) first */
	size_t base[40];
	size_t off = lp_n * (size_t)channels;
	for (int k = n_lvl - 1; k >= 0; k--) {
		base[k] = off;
		off += (size_t)channels * (1 + 3 * (size_t)tgt_w[k] * tgt_h[k]);
	}

	/* buffers, all at level-0 (largest) sizes:
	   lp_h, hp_h : H-pass halves, (2*th x tw) each — the V pass reads
	                their even/odd rows DIRECTLY at stride 2*tw (no
	                staging copies; lift_pair_v's rs argument)
	   llA, llB   : ping-pong LL outputs (the next level's input —
	                level 0 reads the caller's planes in place; the
	                plus-one fake row is virtualized by clamping the
	                H-pass row index, so no buffer ever grows a row)
	   qq, bq, dq : V-pass detail outputs, (th x tw) each
	   rowev/rowod/zrow : (tw) each */
	const size_t qa = (size_t)tgt_w[0] * tgt_h[0];
	int16_t *mem = (int16_t *)calloc(9 * qa + 3 * (size_t)tgt_w[0], 2);
	if (mem == NULL)
		return -2;
	int16_t *lp_h = mem;
	int16_t *hp_h = lp_h + 2 * qa;
	int16_t *llA = hp_h + 2 * qa;
	int16_t *llB = llA + qa;
	int16_t *qq = llB + qa;
	int16_t *bq = qq + qa;
	int16_t *dq = bq + qa;
	int16_t *rowev = dq + qa;
	int16_t *rowod = rowev + tgt_w[0];
	int16_t *zrow = rowod + tgt_w[0]; /* calloc-zeroed; re-zeroed per level */

	for (int ch = 0; ch < channels; ch++) {
		const int16_t *cur = planes + (size_t)ch * area;
		int16_t *nxt = llA;
		for (int k = 0; k < n_lvl; k++) {
			const int cw = cur_w[k], chh = cur_h[k];
			const int tw = tgt_w[k], th = tgt_h[k];
			const size_t n = (size_t)tw * th;
			const int fake_col = 2 * tw - cw;
			const int weff = eff_wavelet(wavelet, tw, th);
			const int32_t q = qs[(size_t)k * channels + ch];
			const int32_t g = gs[(size_t)k * channels + ch];
			int16_t *chunk = stream_out + base[k] + (size_t)ch * (1 + 3 * n);

			/* H pass per row: strided even/odd split in one pass; odd
			   width gets a fake trailing odd equal to the last even,
			   odd height a virtual duplicate of the last row
			   (lifting.c:46-47) via the clamped row index */
			for (int i = 0; i < 2 * th; i++) {
				const int ri = i < chh ? i : chh - 1;
				const int16_t *row = cur + (size_t)ri * cw;
				for (int j = 0; j < tw - fake_col; j++) {
					rowev[j] = row[2 * j];
					rowod[j] = row[2 * j + 1];
				}
				if (fake_col) {
					rowev[tw - 1] = row[2 * (tw - 1)];
					rowod[tw - 1] = rowev[tw - 1];
				}
				lift_pair_1d(weff, wrap, rowev, rowod, tw,
				             lp_h + (size_t)i * tw, hp_h + (size_t)i * tw);
			}

			memset(zrow, 0, (size_t)tw * 2);

			/* V pass on the lowpass half -> LL (next level) + C; even/
			   odd rows read straight from lp_h at stride 2*tw */
			lift_pair_v(weff, wrap, lp_h, lp_h + tw, th, tw, 2 * tw,
			            nxt, qq, zrow);
			chunk[0] = (int16_t)q;
			gate_quant(qq, n, q, g, chunk + 1); /* C (vertical detail) */

			/* V pass on the highpass half -> B + D */
			lift_pair_v(weff, wrap, hp_h, hp_h + tw, th, tw, 2 * tw,
			            bq, dq, zrow);
			gate_quant(bq, n, q, g, chunk + 1 + n);     /* B */
			gate_quant(dq, n, q, g, chunk + 1 + 2 * n); /* D */

			cur = nxt; /* LL becomes the next level's input */
			nxt = (nxt == llA) ? llB : llA;
		}
		memcpy(stream_out + (size_t)ch * lp_n, cur, lp_n * 2);
	}
	free(mem);
	return 0;
}

/*
Forward pixel format: interleaved u8 (h x w x channels) -> planar
int16 (channels x h x w) with optional discard-non-visible and the
forward color transform (ops/colorspace.py:to_planar_yuv,
format.c:64-133).
*/
/* Specialized YCoCg forward for the common shapes: compile-time
   channel count and Q flag (always_inline + literal args below), no
   plane readback, so the whole transform auto-vectorizes — ~20x the
   generic loop (the generic loop's runtime channel stride and
   per-pixel mode branches defeat the vectorizer). Identical int16
   cast chain; oracle-gated like the generic path. */
__attribute__((always_inline)) static inline void
u8_to_planes_ycocg(const uint8_t *il, size_t area, int ch, int qdouble,
                   int16_t *pl)
{
	int16_t *py = pl, *pco = pl + area, *pcg = pl + 2 * area;
	int16_t *pa = pl + 3 * area;
	for (size_t p = 0; p < area; p++) {
		const int32_t r = il[p * ch], g = il[p * ch + 1];
		const int32_t b = il[p * ch + 2];
		const int32_t co = (int16_t)(r - b);
		const int32_t tmp = (int16_t)(b + co / 2);
		const int32_t cg = (int16_t)(g - tmp);
		int32_t y = (int16_t)(tmp + cg / 2);
		if (qdouble)
			y = (int16_t)(y * 2);
		py[p] = (int16_t)y;
		pco[p] = (int16_t)co;
		pcg[p] = (int16_t)cg;
		if (ch == 4)
			pa[p] = il[p * ch + 3];
	}
}

API void akort_u8_to_planes(const uint8_t *ileaved, int32_t w, int32_t h,
                            int32_t channels, int32_t color, int32_t discard,
                            int16_t *planes_out)
{
	const size_t area = (size_t)w * h;
	const int do_color =
	    channels >= 3 &&
	    (color == CL_YCOCG || color == CL_YCOCG_Q || color == CL_SUBG);
	const int do_discard = discard && (channels == 2 || channels == 4);

	if (do_color && !do_discard && color != CL_SUBG &&
	    (channels == 3 || channels == 4)) {
		const int q = color == CL_YCOCG_Q;
		if (channels == 4 && q)
			u8_to_planes_ycocg(ileaved, area, 4, 1, planes_out);
		else if (channels == 4)
			u8_to_planes_ycocg(ileaved, area, 4, 0, planes_out);
		else if (q)
			u8_to_planes_ycocg(ileaved, area, 3, 1, planes_out);
		else
			u8_to_planes_ycocg(ileaved, area, 3, 0, planes_out);
		return;
	}

	for (size_t p = 0; p < area; p++) {
		const uint8_t *px = ileaved + p * (size_t)channels;
		if (do_discard && px[channels - 1] == 0) {
			for (int32_t c = 0; c + 1 < channels; c++)
				planes_out[(size_t)c * area + p] = 0;
			planes_out[(size_t)(channels - 1) * area + p] = 0;
		} else {
			for (int32_t c = 0; c < channels; c++)
				planes_out[(size_t)c * area + p] = px[c];
		}
		if (do_color) {
			const int32_t r = planes_out[p];
			const int32_t g = planes_out[area + p];
			const int32_t b = planes_out[2 * area + p];
			if (color == CL_SUBG) {
				planes_out[p] = (int16_t)g;
				planes_out[area + p] = (int16_t)(r - g);
				planes_out[2 * area + p] = (int16_t)(b - g);
			} else {
				const int32_t co = (int16_t)(r - b);
				const int32_t tmp = (int16_t)(b + co / 2);
				const int32_t cg = (int16_t)(g - tmp);
				int32_t y = (int16_t)(tmp + cg / 2);
				if (color == CL_YCOCG_Q)
					y = (int16_t)(y * 2);
				planes_out[p] = (int16_t)y;
				planes_out[area + p] = (int16_t)co;
				planes_out[2 * area + p] = (int16_t)cg;
			}
		}
	}
}

/* ------------------------------------------------------------------ */
/* "Manbavaran" rANS entropy coder — the format's reserved second      */
/* compression method (reference ako.h:71 AKO_COMPRESSION_MANBAVARAN,  */
/* never implemented there: compression.c:39 ignores `method`). This   */
/* is an ako_tpu EXTENSION with a defined wire format:                 */
/*                                                                     */
/*   block   := [u32 block_size][payload]           (same framing)     */
/*   payload := [u8 magic 0x52]['R': distinguishes real rANS payloads  */
/*              from reference-style Kagari bytes under the same       */
/*              reserved method flag][u32 rans_size]                   */
/*              [17 x u16 freq (12-bit scale)][u32 final_state]        */
/*              [rans bytes...][extras bitstream]                      */
/*                                                                     */
/* Values map exactly like Kagari's zigzag (incl. the u16 wrap for     */
/* -32768): m = (u16)(zigzag(v) + 1), EXCEPT m = 0 denotes 65536 so    */
/* every value is codable: sym = bit_length-1 of the 1..65536 code     */
/* (0..16), extras = low `sym` bits, packed MSB-first in symbol        */
/* order. Symbols are rANS-coded (Duda 2014; 32-bit state, 8-bit       */
/* renorm, 12-bit probabilities) under a per-block static model.       */
/* Encoded back-to-front so decode streams forward — the same          */
/* property the device's block-parallel decoder relies on.             */

#define MANBA_SYMS 17
#define MANBA_PROB_BITS 12
#define MANBA_PROB_SCALE (1u << MANBA_PROB_BITS)
#define MANBA_STATE_LO (1u << 23)
#define MANBA_MAGIC 0x52u /* 'R' */
#define MANBA_HEAD_BYTES (1u + 4u + 2u * MANBA_SYMS + 4u)

static int manba_sym(uint16_t u /* zigzag(v) */, uint32_t *m_out)
{
	/* code m in 1..65536; zigzag(-32768)+1 wraps to 0 == 65536 */
	const uint32_t m = ((uint32_t)u + 1u) & 0xFFFFu;
	const uint32_t code = (m == 0) ? 65536u : m;
	int s = 0;
	while ((code >> (s + 1)) != 0)
		s++;
	*m_out = code;
	return s; /* 0..16 */
}

/* Build the quantized model; returns 0 on success. */
static int manba_model(const uint32_t *hist, uint16_t *freq_out)
{
	uint64_t total = 0;
	for (int s = 0; s < MANBA_SYMS; s++)
		total += hist[s];
	if (total == 0)
		return -1;
	uint32_t sum = 0;
	int maxi = 0;
	for (int s = 0; s < MANBA_SYMS; s++) {
		uint32_t f = (uint32_t)(((uint64_t)hist[s] * MANBA_PROB_SCALE) / total);
		if (hist[s] > 0 && f == 0)
			f = 1;
		freq_out[s] = (uint16_t)f;
		sum += f;
		if (freq_out[s] > freq_out[maxi])
			maxi = s;
	}
	/* settle rounding drift on the most frequent symbol */
	const int32_t drift = (int32_t)MANBA_PROB_SCALE - (int32_t)sum;
	if ((int32_t)freq_out[maxi] + drift < 1)
		return -1;
	freq_out[maxi] = (uint16_t)((int32_t)freq_out[maxi] + drift);
	return 0;
}

API size_t akort_manba_encode(const void *input, size_t input_size,
                              void *output, size_t output_size)
{
	const int16_t *in = (const int16_t *)input;
	const size_t n = input_size / 2;
	uint8_t *out = (uint8_t *)output;

	if (input_size == 0 || (input_size % 2) != 0 || output_size == 0)
		return 0;

	/* pass 1: symbols + extras sizes + histogram */
	uint32_t hist[MANBA_SYMS] = {0};
	uint64_t extra_bits = 0;
	for (size_t i = 0; i < n; i++) {
		uint32_t m;
		const int s = manba_sym(zigzag16(in[i]), &m);
		hist[s]++;
		extra_bits += (uint64_t)s;
	}
	uint16_t freq[MANBA_SYMS];
	if (manba_model(hist, freq) != 0)
		return 0;
	uint32_t cum[MANBA_SYMS + 1];
	cum[0] = 0;
	for (int s = 0; s < MANBA_SYMS; s++)
		cum[s + 1] = cum[s] + freq[s];

	const size_t extras_bytes = (size_t)((extra_bits + 7) / 8);

	/* pass 2: rANS over symbols, back-to-front. Renorm bytes are
	   emitted newest-first into a scratch region at the END of the
	   caller's output buffer, then reversed into place — bounded by
	   output_size, so incompressible blocks fail cleanly like Kagari */
	if (output_size < MANBA_HEAD_BYTES + extras_bytes)
		return 0;
	uint8_t *scratch_lim = out + output_size;
	uint8_t *sp = scratch_lim; /* grows downward */
	uint8_t *const floor_ = out + MANBA_HEAD_BYTES + extras_bytes;
	uint32_t x = MANBA_STATE_LO;
	for (size_t i = n; i-- > 0;) {
		uint32_t m;
		const int s = manba_sym(zigzag16(in[i]), &m);
		const uint32_t f = freq[s];
		const uint32_t x_max = ((MANBA_STATE_LO >> MANBA_PROB_BITS) << 8) * f;
		while (x >= x_max) {
			if (sp <= floor_)
				return 0;
			*--sp = (uint8_t)(x & 0xFF);
			x >>= 8;
		}
		x = ((x / f) << MANBA_PROB_BITS) + (x % f) + cum[s];
	}
	const size_t rans_bytes = (size_t)(scratch_lim - sp);
	const size_t total = MANBA_HEAD_BYTES + rans_bytes + extras_bytes;
	if (total > output_size)
		return 0;

	/* header */
	out[0] = MANBA_MAGIC;
	out[1] = (uint8_t)(rans_bytes & 0xFF);
	out[2] = (uint8_t)((rans_bytes >> 8) & 0xFF);
	out[3] = (uint8_t)((rans_bytes >> 16) & 0xFF);
	out[4] = (uint8_t)((rans_bytes >> 24) & 0xFF);
	for (int s = 0; s < MANBA_SYMS; s++) {
		out[5 + 2 * s] = (uint8_t)(freq[s] & 0xFF);
		out[6 + 2 * s] = (uint8_t)(freq[s] >> 8);
	}
	uint8_t *p = out + 5 + 2 * MANBA_SYMS;
	p[0] = (uint8_t)(x & 0xFF);
	p[1] = (uint8_t)((x >> 8) & 0xFF);
	p[2] = (uint8_t)((x >> 16) & 0xFF);
	p[3] = (uint8_t)((x >> 24) & 0xFF);
	p += 4;
	/* rans bytes: sp already holds them oldest-first (we emitted
	   newest-first growing downward, so sp..scratch_lim is exactly
	   decode order) */
	memmove(p, sp, rans_bytes);
	p += rans_bytes;

	/* pass 3: extras bitstream, MSB-first in symbol order */
	memset(p, 0, extras_bytes);
	uint64_t bitpos = 0;
	for (size_t i = 0; i < n; i++) {
		uint32_t m;
		const int s = manba_sym(zigzag16(in[i]), &m);
		const uint32_t extra = m - (1u << s);
		for (int b = s - 1; b >= 0; b--) {
			if ((extra >> b) & 1u)
				p[bitpos >> 3] |= (uint8_t)(0x80u >> (bitpos & 7));
			bitpos++;
		}
	}
	return total;
}

API size_t akort_manba_decode(size_t count, const void *input,
                              size_t input_size, void *output,
                              size_t output_size)
{
	const uint8_t *in = (const uint8_t *)input;
	int16_t *out = (int16_t *)output;

	if (count == 0 || input_size < MANBA_HEAD_BYTES || output_size < count * 2)
		return 0;

	if (in[0] != MANBA_MAGIC)
		return 0;
	const uint32_t rans_bytes =
	    (uint32_t)in[1] | ((uint32_t)in[2] << 8) | ((uint32_t)in[3] << 16) |
	    ((uint32_t)in[4] << 24);
	uint16_t freq[MANBA_SYMS];
	uint32_t cum[MANBA_SYMS + 1];
	cum[0] = 0;
	for (int s = 0; s < MANBA_SYMS; s++) {
		freq[s] = (uint16_t)((uint32_t)in[5 + 2 * s] |
		                     ((uint32_t)in[6 + 2 * s] << 8));
		cum[s + 1] = cum[s] + freq[s];
	}
	if (cum[MANBA_SYMS] != MANBA_PROB_SCALE)
		return 0;
	if (input_size < (size_t)MANBA_HEAD_BYTES + rans_bytes)
		return 0;
	const uint8_t *rp = in + 5 + 2 * MANBA_SYMS;
	uint32_t x = (uint32_t)rp[0] | ((uint32_t)rp[1] << 8) |
	             ((uint32_t)rp[2] << 16) | ((uint32_t)rp[3] << 24);
	rp += 4;
	const uint8_t *const rlim = rp + rans_bytes;
	const uint8_t *const extras = rlim;
	const uint64_t extras_avail =
	    ((uint64_t)(input_size - MANBA_HEAD_BYTES - rans_bytes)) * 8u;

	uint64_t bitpos = 0;
	for (size_t i = 0; i < count; i++) {
		const uint32_t slot = x & (MANBA_PROB_SCALE - 1);
		int s = 0;
		while (s < MANBA_SYMS - 1 && cum[s + 1] <= slot)
			s++;
		if (freq[s] == 0)
			return 0;
		x = freq[s] * (x >> MANBA_PROB_BITS) + slot - cum[s];
		while (x < MANBA_STATE_LO && rp < rlim)
			x = (x << 8) | *rp++;
		uint32_t extra = 0;
		if (s > 0) {
			if (bitpos + (uint64_t)s > extras_avail)
				return 0;
			for (int b = 0; b < s; b++) {
				extra = (extra << 1) |
				        ((extras[bitpos >> 3] >> (7 - (bitpos & 7))) & 1u);
				bitpos++;
			}
		}
		const uint32_t code = (1u << s) + extra; /* 1..65536 */
		out[i] = unzigzag16((uint16_t)(code - 1u)); /* 65536 wraps to 0 */
	}
	/* Final-state verification: a valid stream must return the rANS
	   state to the encoder's initial MANBA_STATE_LO with every renorm
	   byte consumed and at most 7 bits of extras padding left. This is
	   what makes the reserved-flag auto-detect safe: a Kagari payload
	   that happened to pass the magic + model checks has a ~2^-32
	   chance of also landing the state/stream bounds exactly. */
	if (x != MANBA_STATE_LO || rp != rlim || bitpos + 8u <= extras_avail)
		return 0;
	return input_size;
}

/*
Sync scan for the device-side parallel Manbavaran decoder: walk the
rANS payload exactly like akort_manba_decode, recording the decoder
state every `block`-th output: (rANS state x, next unread rans byte
index RELATIVE to the payload start, extras bit index relative to the
extras region start). A TPU program then decodes all blocks in
parallel from these records (ops/manba_device.py), bit-exactly.

Also writes the model (17 freqs) and the region offsets the device
needs: *rans_off = first rans byte (absolute, after state), *extras_off
= first extras byte (absolute), *rans_end = one past the last rans
byte. Returns input_size on success (consumed = whole payload), 0 on
any header/bounds failure — the same conditions akort_manba_decode
rejects.
*/
API size_t akort_manba_sync(size_t count, const void *input, size_t input_size,
                            size_t block, uint32_t *x_arr, uint32_t *rbyte_arr,
                            uint32_t *ebit_arr, uint16_t *freq_out,
                            uint32_t *rans_off, uint32_t *rans_end,
                            uint32_t *extras_off)
{
	const uint8_t *in = (const uint8_t *)input;

	if (count == 0 || block == 0 || input_size < MANBA_HEAD_BYTES)
		return 0;
	if (in[0] != MANBA_MAGIC)
		return 0;
	const uint32_t rans_bytes =
	    (uint32_t)in[1] | ((uint32_t)in[2] << 8) | ((uint32_t)in[3] << 16) |
	    ((uint32_t)in[4] << 24);
	uint16_t freq[MANBA_SYMS];
	uint32_t cum[MANBA_SYMS + 1];
	cum[0] = 0;
	for (int s = 0; s < MANBA_SYMS; s++) {
		freq[s] = (uint16_t)((uint32_t)in[5 + 2 * s] |
		                     ((uint32_t)in[6 + 2 * s] << 8));
		freq_out[s] = freq[s];
		cum[s + 1] = cum[s] + freq[s];
	}
	if (cum[MANBA_SYMS] != MANBA_PROB_SCALE)
		return 0;
	if (input_size < (size_t)MANBA_HEAD_BYTES + rans_bytes)
		return 0;
	const size_t rstart = 5 + 2 * MANBA_SYMS + 4;
	const uint8_t *rp = in + rstart;
	uint32_t x = (uint32_t)in[rstart - 4] | ((uint32_t)in[rstart - 3] << 8) |
	             ((uint32_t)in[rstart - 2] << 16) |
	             ((uint32_t)in[rstart - 1] << 24);
	const uint8_t *const rlim = rp + rans_bytes;
	const uint8_t *const extras = rlim;
	const uint64_t extras_avail =
	    ((uint64_t)(input_size - MANBA_HEAD_BYTES - rans_bytes)) * 8u;
	*rans_off = (uint32_t)rstart;
	*rans_end = (uint32_t)(rstart + rans_bytes);
	*extras_off = (uint32_t)(rstart + rans_bytes);

	uint64_t bitpos = 0;
	size_t rec = 0;
	const size_t n_rec = (count + block - 1) / block;
	for (size_t i = 0; i < count; i++) {
		if (rec < n_rec && (i % block) == 0) {
			x_arr[rec] = x;
			rbyte_arr[rec] = (uint32_t)(rp - in);
			ebit_arr[rec] = (uint32_t)bitpos;
			rec++;
		}
		const uint32_t slot = x & (MANBA_PROB_SCALE - 1);
		int s = 0;
		while (s < MANBA_SYMS - 1 && cum[s + 1] <= slot)
			s++;
		if (freq[s] == 0)
			return 0;
		x = freq[s] * (x >> MANBA_PROB_BITS) + slot - cum[s];
		while (x < MANBA_STATE_LO && rp < rlim)
			x = (x << 8) | *rp++;
		if (s > 0) {
			if (bitpos + (uint64_t)s > extras_avail)
				return 0;
			bitpos += (uint64_t)s;
		}
	}
	/* same final-state verification as akort_manba_decode: the sync
	   scan vouches for the whole stream before the device decodes it */
	if (x != MANBA_STATE_LO || rp != rlim || bitpos + 8u <= extras_avail)
		return 0;
	(void)extras;
	return input_size;
}

/* ------------------------------------------------------------------ */
/* Whole-tile single-call compositions: one native call per tile      */
/* instead of three ctypes crossings + Python glue. The host pipeline */
/* fans tiles out on a thread pool; every Python<->C transition runs  */
/* under the GIL, so per-tile call count is a direct serial cost      */
/* (runtime/hostcodec.py tile_encode_block / tile_decode_block).      */

/* u8 tile -> Kagari payload (no 4-byte frame head; the caller packs
   it). Returns payload bytes, 0 when incompressible (capacity) or on
   allocation failure (distinguished via *rc_out: 0 ok, -2 alloc). */
API size_t akort_tile_encode_block(const uint8_t *tile, int32_t tile_w,
                                   int32_t tile_h, int32_t channels,
                                   int32_t wavelet, int32_t wrap,
                                   int32_t color, int32_t discard_nv,
                                   const int32_t *qs, const int32_t *gs,
                                   size_t stream_elems, uint8_t *out,
                                   size_t out_capacity, int32_t *rc_out)
{
	const size_t area = (size_t)tile_w * tile_h;
	*rc_out = 0;
	int16_t *mem = (int16_t *)malloc((area * (size_t)channels + stream_elems) * 2);
	if (mem == NULL) {
		*rc_out = -2;
		return 0;
	}
	int16_t *planes = mem;
	int16_t *stream = mem + area * (size_t)channels;
	akort_u8_to_planes(tile, tile_w, tile_h, channels, color, discard_nv,
	                   planes);
	const int32_t rc = akort_tile_lift(planes, tile_w, tile_h, channels,
	                                   wavelet, wrap, qs, gs, stream,
	                                   stream_elems);
	if (rc != 0) {
		free(mem);
		*rc_out = rc;
		return 0;
	}
	const size_t n = akort_kagari_encode(stream, stream_elems * 2, out,
	                                     out_capacity);
	free(mem);
	return n;
}

/* Kagari payload -> u8 pixels. Returns 0 on success, 1 on broken
   input (decode failure or consumed != payload size — the
   decompress_block contract), -2 on allocation failure. */
API int32_t akort_tile_decode_block(const uint8_t *payload,
                                    size_t payload_size, size_t count,
                                    size_t output_capacity_bytes,
                                    int32_t tile_w, int32_t tile_h,
                                    int32_t channels, int32_t wavelet,
                                    int32_t wrap, int32_t color,
                                    uint8_t *pixels_out)
{
	const size_t area = (size_t)tile_w * tile_h;
	const size_t cap = output_capacity_bytes < 2 ? 2 : output_capacity_bytes;
	int16_t *mem =
	    (int16_t *)calloc(cap / 2 + area * (size_t)channels, 2);
	if (mem == NULL)
		return -2;
	int16_t *values = mem;
	int16_t *planes = mem + cap / 2;
	const size_t consumed = akort_kagari_decode(count, payload, payload_size,
	                                            values, output_capacity_bytes);
	if (consumed == 0 || consumed != payload_size) {
		free(mem);
		return 1;
	}
	const int32_t rc = akort_tile_unlift(values, count, tile_w, tile_h,
	                                     channels, wavelet, wrap, planes);
	if (rc != 0) {
		free(mem);
		return 1;
	}
	akort_planes_to_u8(planes, tile_w, tile_h, channels, color, pixels_out);
	free(mem);
	return 0;
}

/* ------------------------------------------------------------------ */
/* Multi-tile span compositions: one native call per SPAN of tiles.   */
/* The host pipeline's worker pool used to cross Python<->C once per  */
/* tile plus per-tile numpy glue (tile slicing, qg lookup, framing),  */
/* all of it under the GIL; with 4 workers that glue serialized ~35%  */
/* of the wall time (devbench/time_tile.c vs the measured pipeline).  */
/* A span call takes the WHOLE image pointer plus per-tile geometry   */
/* arrays precomputed once per (shape, settings) and cached, so the   */
/* per-tile Python cost drops to a byte-slice join at drain time.     */

/* Encode tiles [0, n) of a span: for each tile i, gather the rect
   rects[4i..4i+3] (x, y, w, h) out of the interleaved u8 image
   (row_stride bytes between rows), run the single-call block encoder,
   and write the 4-byte little-endian block head + payload at
   out + out_off[i]. sizes[i] = payload bytes (0 = incompressible at
   caps[i]). Returns 0, or -2 on allocation failure. Byte-identical to
   per-tile akort_tile_encode_block calls by construction (it IS that
   call on a gathered copy). */
API int32_t akort_tile_encode_spans(
    const uint8_t *image, int64_t row_stride, int32_t channels,
    int32_t wavelet, int32_t wrap, int32_t color, int32_t discard_nv,
    int32_t n, const int32_t *rects, const int64_t *qg_off,
    const int32_t *qs, const int32_t *gs, const int64_t *counts,
    const int64_t *caps, uint8_t *out, const int64_t *out_off,
    int64_t *sizes)
{
	size_t max_tile = 0;
	for (int32_t i = 0; i < n; i++) {
		const size_t bytes = (size_t)rects[4 * i + 2] *
		                     (size_t)rects[4 * i + 3] *
		                     (size_t)channels;
		if (bytes > max_tile)
			max_tile = bytes;
	}
	uint8_t *scratch = (uint8_t *)malloc(max_tile ? max_tile : 1);
	if (scratch == NULL)
		return -2;
	for (int32_t i = 0; i < n; i++) {
		const int32_t x = rects[4 * i + 0], y = rects[4 * i + 1];
		const int32_t w = rects[4 * i + 2], h = rects[4 * i + 3];
		const size_t row = (size_t)w * (size_t)channels;
		for (int32_t r = 0; r < h; r++)
			memcpy(scratch + (size_t)r * row,
			       image + (size_t)(y + r) * (size_t)row_stride +
			           (size_t)x * (size_t)channels,
			       row);
		int32_t rc = 0;
		const size_t m = akort_tile_encode_block(
		    scratch, w, h, channels, wavelet, wrap, color, discard_nv,
		    qs ? qs + qg_off[i] : NULL, gs ? gs + qg_off[i] : NULL,
		    (size_t)counts[i], out + out_off[i] + 4,
		    (size_t)caps[i], &rc);
		if (m == 0 && rc == -2) {
			free(scratch);
			return -2;
		}
		sizes[i] = (int64_t)m;
		if (m != 0) {
			uint8_t *head = out + out_off[i];
			head[0] = (uint8_t)(m & 0xFF);
			head[1] = (uint8_t)((m >> 8) & 0xFF);
			head[2] = (uint8_t)((m >> 16) & 0xFF);
			head[3] = (uint8_t)((m >> 24) & 0xFF);
		}
	}
	free(scratch);
	return 0;
}

/* Decode tiles [0, n) of a span: each tile's payload lives at
   blob + pay_off[i] (pay_size[i] bytes); decoded pixels land directly
   in the interleaved u8 image at rects[4i..] with row_stride bytes
   between rows. Returns 0 on success, i + 1 for the first tile whose
   payload is broken, -2 on allocation failure. Spans over disjoint
   rects may run concurrently against the same image buffer. */
API int32_t akort_tile_decode_spans(
    const uint8_t *blob, const int64_t *pay_off, const int64_t *pay_size,
    const int64_t *counts, const int64_t *caps, int32_t n,
    const int32_t *rects, int64_t row_stride, int32_t channels,
    int32_t wavelet, int32_t wrap, int32_t color, uint8_t *image_out)
{
	size_t max_tile = 0;
	for (int32_t i = 0; i < n; i++) {
		const size_t bytes = (size_t)rects[4 * i + 2] *
		                     (size_t)rects[4 * i + 3] *
		                     (size_t)channels;
		if (bytes > max_tile)
			max_tile = bytes;
	}
	size_t max_cap = 0;
	for (int32_t i = 0; i < n; i++)
		if ((size_t)caps[i] > max_cap)
			max_cap = (size_t)caps[i];
	/* two slots: entropy decode runs PAIRED (kagari_decode_pair
	   overlaps the two streams' serial bit chains); unlift + color +
	   placement then run per tile. Per-slot scratch: the values
	   buffer (caps bytes), the planar buffer, and the pixel tile. */
	const size_t slot = max_cap / 2 + max_tile; /* int16 elements */
	int16_t *mem = (int16_t *)malloc((2 * slot ? 2 * slot : 1) * 2);
	uint8_t *scratch = (uint8_t *)malloc(max_tile ? max_tile : 1);
	if (mem == NULL || scratch == NULL) {
		free(mem);
		free(scratch);
		return -2;
	}

	int32_t fail = 0;
	for (int32_t i = 0; i < n && fail == 0; i += 2) {
		const int pair = i + 1 < n;
		KD kd[2];
		int ok[2] = {0, 0};
		for (int k = 0; k < (pair ? 2 : 1); k++)
			ok[k] = kd_init(&kd[k], (size_t)counts[i + k],
			                blob + pay_off[i + k],
			                (size_t)pay_size[i + k],
			                mem + (size_t)k * slot,
			                (size_t)caps[i + k]);
		if (pair && ok[0] && ok[1])
			kagari_decode_pair(&kd[0], &kd[1]);
		else if (ok[0])
			while (kd[0].state == 0)
				kd_step(&kd[0]);
		/* (!ok[0]: tile i is already broken and reported below at
		   k = 0; i+1 stays unexamined, matching sequential order) */
		for (int k = 0; k < (pair ? 2 : 1); k++) {
			const int32_t x = rects[4 * (i + k) + 0];
			const int32_t y = rects[4 * (i + k) + 1];
			const int32_t w = rects[4 * (i + k) + 2];
			const int32_t h = rects[4 * (i + k) + 3];
			const size_t consumed =
			    ok[k] ? kd_consumed(&kd[k]) : 0;
			if (consumed == 0 || consumed != (size_t)pay_size[i + k]) {
				fail = i + k + 1;
				break;
			}
			int16_t *planes = mem + (size_t)k * slot + max_cap / 2;
			const int32_t rc = akort_tile_unlift(
			    mem + (size_t)k * slot, (size_t)counts[i + k], w,
			    h, channels, wavelet, wrap, planes);
			if (rc != 0) {
				fail = i + k + 1;
				break;
			}
			akort_planes_to_u8(planes, w, h, channels, color,
			                   scratch);
			const size_t row = (size_t)w * (size_t)channels;
			for (int32_t r = 0; r < h; r++)
				memcpy(image_out +
				           (size_t)(y + r) * (size_t)row_stride +
				           (size_t)x * (size_t)channels,
				       scratch + (size_t)r * row, row);
		}
	}
	free(mem);
	free(scratch);
	return fail;
}
