// Exact per-slot int64 sums of K pre-masked vectors, keyed by dense slot ids.
//
// Replaces the Pallas kernel duckdb_tpu/ops/pallas_agg.py:_kernel (launched
// by grouped_sum_i64). That kernel splits every int64 into 8-bit limbs and
// sums them on the TPU's matrix unit because the v5e has no 64-bit
// datapath. Hopper adds int64 natively, so none of that carries over, and
// the tensor cores have nothing to take: the work is one add per value.
//
// Bound on this card: memory. The kernel reads N x (4 + 8K) bytes once and
// does K adds per row, far below the card's integer rate; at 3.35 TB/s the
// bytes set the floor. What keeps a simple kernel off that floor is the
// per-slot accumulation: with few live slots (TPC-H Q1 has 4 of 20) the 32
// lanes of a warp hit the same few shared words, and same-address shared
// atomics serialise. Two regimes, chosen by the wrapper from nseg:
//
// * small (nseg + 1 slot rows fit two blocks' tables on an SM): no atomics
//   in the row loop. Each warp owns a lane-private table in shared memory:
//   cell (slot s, vector g) of lane l is acc[(s * G + g) * 32 + l]. A lane
//   adds its rows with plain load-add-store into its own column, so no two
//   lanes share a word and a warp's 32 accesses take 2 wavefronts, the
//   least for 64-bit words, whatever the ids. Dead ids go to a spare row
//   nseg, so the loop has no branch. A table holds G vectors; blockIdx.y
//   picks the block's group of G, so blocks of one x walk the same rows and
//   the ids come from device memory once (the other groups re-read them
//   from L2). Each lane loads 16 bytes at a time: four ids, two values of
//   each vector. Loads of the next tile are issued before the adds of this
//   one. At the end the block folds the 32 columns of its 8 warps into
//   each cell and flushes it with one global atomic.
// * large (up to 256 slots and beyond): one (nseg, K) table per block with
//   rows K | 1 words long (an even length puts every slot's row on the same
//   bank). Lanes of a warp that hold the same slot id find each other with
//   __match_any_sync and sum their K values with a log-step shuffle tree;
//   only the lowest lane of each group does the K shared atomics. A warp
//   whose 32 rows all fall in one slot does K atomics instead of 32 K.
//   Each 64-bit add is two native 32-bit shared atomics (add_u64_shared):
//   on this card the 64-bit shared atomicAdd is a compare-and-swap loop.
//
// Unsigned addition wraps mod 2^64 and is associative, so the result is
// bit-identical to a sequential int64 sum whatever order anything lands in.
// Both kernels run a persistent grid sized by the occupancy calculator.
// The lane-private table and the warp intrinsics are why this is CUDA C++
// and not Triton: Triton has no per-lane addressing of shared memory.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

#define GS_MAX_K 24
#define GS_WARPS 8
#define GS_THREADS (GS_WARPS * 32)
#define GS_LANE_ROWS 4                      // rows per lane per tile (16-byte id load)
#define GS_TILE (32 * GS_LANE_ROWS)         // rows per warp per tile
#define GS_SMEM_MAX 232448                  // opt-in shared memory of one block

typedef unsigned long long u64;

struct VecPtrs {
    const long long* p[GS_MAX_K];
};

__device__ __forceinline__ u64 warp_sum(u64 x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

// A 64-bit atomicAdd on shared memory compiles to a compare-and-swap spin
// loop on sm_90a (ATOMS.CAST.SPIN.64); a 32-bit one is a native ATOMS.ADD.
// So add the low words natively, take the carry out of the low word from
// the old value it returns, and add it with the high words. Every wrap of
// the low word is seen by exactly one adder, so the pair is exact mod 2^64.
__device__ __forceinline__ void add_u64_shared(u64* a, u64 v) {
    unsigned* w = reinterpret_cast<unsigned*>(a);  // little-endian: low word first
    const unsigned lo = (unsigned)v;
    const unsigned old = atomicAdd(w, lo);
    const unsigned hi = (unsigned)(v >> 32) + ((unsigned)(old + lo) < old ? 1u : 0u);
    if (hi) atomicAdd(w + 1, hi);
}

template <int G>
__global__ void __launch_bounds__(GS_THREADS)
grouped_sum_small(const int* __restrict__ dense, VecPtrs vecs, long long n,
                  int k, int nseg, u64* __restrict__ out) {
    extern __shared__ u64 acc[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warp_cells = (nseg + 1) * G;  // one warp's cells, spare row included
    for (int i = threadIdx.x; i < GS_WARPS * warp_cells * 32; i += GS_THREADS)
        acc[i] = 0ULL;
    __syncthreads();

    const int g0 = blockIdx.y * G;
    const int gk = min(G, k - g0);  // vectors of this block's group
    const long long* p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) p[g] = vecs.p[g < gk ? g0 + g : g0];
    u64* mine = acc + warp * warp_cells * 32 + lane;
    auto cell = [nseg](int s) { return ((unsigned)s < (unsigned)nseg ? s : nseg) * G; };

    const long long ntiles = n / GS_TILE;
    const long long nw = (long long)gridDim.x * GS_WARPS;
    long long t = (long long)blockIdx.x * GS_WARPS + warp;
    int4 id;
    longlong2 va[G], vb[G];
    if (t < ntiles) {
        const long long row = t * GS_TILE + lane * GS_LANE_ROWS;
        id = __ldg(reinterpret_cast<const int4*>(dense + row));
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (g < gk) {
                va[g] = __ldg(reinterpret_cast<const longlong2*>(p[g] + row));
                vb[g] = __ldg(reinterpret_cast<const longlong2*>(p[g] + row + 2));
            }
        }
    }
    while (t < ntiles) {
        const long long tn = t + nw;
        int4 nid;
        longlong2 na[G], nb[G];
        if (tn < ntiles) {  // the next tile's loads go out before this tile's adds
            const long long row = tn * GS_TILE + lane * GS_LANE_ROWS;
            nid = __ldg(reinterpret_cast<const int4*>(dense + row));
#pragma unroll
            for (int g = 0; g < G; ++g) {
                if (g < gk) {
                    na[g] = __ldg(reinterpret_cast<const longlong2*>(p[g] + row));
                    nb[g] = __ldg(reinterpret_cast<const longlong2*>(p[g] + row + 2));
                }
            }
        }
        const int c0 = cell(id.x), c1 = cell(id.y), c2 = cell(id.z), c3 = cell(id.w);
#pragma unroll
        for (int g = 0; g < G; ++g) {
            if (g < gk) {
                mine[(c0 + g) * 32] += (u64)va[g].x;
                mine[(c1 + g) * 32] += (u64)va[g].y;
                mine[(c2 + g) * 32] += (u64)vb[g].x;
                mine[(c3 + g) * 32] += (u64)vb[g].y;
            }
        }
        id = nid;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            va[g] = na[g];
            vb[g] = nb[g];
        }
        t = tn;
    }
    if (blockIdx.x == 0 && warp == 0) {  // the ragged rows after the last whole tile
        for (long long row = ntiles * GS_TILE + lane; row < n; row += 32) {
            const int c = cell(dense[row]);
#pragma unroll
            for (int g = 0; g < G; ++g)
                if (g < gk) mine[(c + g) * 32] += (u64)p[g][row];
        }
    }
    __syncthreads();

    // fold: one warp per (slot, vector) cell, lane l sums column l over the
    // block's warps, then the warp sums its lanes; the spare row is skipped
    for (int c = warp; c < nseg * G; c += GS_WARPS) {
        u64 s = 0ULL;
#pragma unroll
        for (int w = 0; w < GS_WARPS; ++w) s += acc[(w * warp_cells + c) * 32 + lane];
        s = warp_sum(s);
        const int g = c % G;
        if (lane == 0 && g < gk && s != 0ULL) atomicAdd(out + (c / G) * k + g0 + g, s);
    }
}

__global__ void __launch_bounds__(GS_THREADS)
grouped_sum_large(const int* __restrict__ dense, VecPtrs vecs, long long n,
                  int k, int nseg, u64* __restrict__ out) {
    extern __shared__ u64 acc[];
    const int ks = k | 1;  // row length of the table: odd, see above
    const int cells = nseg * ks;
    for (int i = threadIdx.x; i < cells; i += GS_THREADS) acc[i] = 0ULL;
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;  // lanes under this one
    const unsigned above = ~((2u << lane) - 1u);  // lanes over this one
    const long long nw = (long long)gridDim.x * GS_WARPS;
    for (long long base = ((long long)blockIdx.x * GS_WARPS + (threadIdx.x >> 5)) * 32;
         base < n; base += nw * 32) {
        const long long row = base + lane;
        const bool in = row < n;
        const int raw = in ? __ldg(dense + row) : -1;
        const int s = (unsigned)raw < (unsigned)nseg ? raw : nseg;  // nseg: dead
        u64 v[GS_MAX_K];
#pragma unroll
        for (int j = 0; j < GS_MAX_K; ++j)
            v[j] = (j < k && in) ? (u64)__ldg(vecs.p[j] + row) : 0ULL;

        // sum each group of lanes with one slot id into its lowest lane:
        // step i adds the value of the next remaining peer, then drops the
        // peers whose rank has bit i set (they were summed in this step)
        const unsigned group = __match_any_sync(0xffffffffu, s);
        unsigned rank = __popc(group & below);
        unsigned peers = group & above;
        while (__any_sync(0xffffffffu, peers != 0u)) {
            const int next = __ffs(peers);  // 1 + the next peer's lane, 0 if none
            const int src = next ? next - 1 : lane;
#pragma unroll
            for (int j = 0; j < GS_MAX_K; ++j) {
                if (j < k) {
                    const u64 t = __shfl_sync(0xffffffffu, v[j], src);
                    if (next) v[j] += t;
                }
            }
            peers &= ~__ballot_sync(0xffffffffu, rank & 1u);
            rank >>= 1;
        }
        if ((group & below) == 0u && s < nseg) {
            u64* a = acc + s * ks;
#pragma unroll
            for (int j = 0; j < GS_MAX_K; ++j)
                if (j < k) add_u64_shared(a + j, v[j]);
        }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < cells; i += GS_THREADS) {
        const int s = i / ks, j = i - s * ks;
        const u64 v = acc[i];
        if (j < k && v != 0ULL) atomicAdd(out + s * k + j, v);
    }
}

// Dynamic shared memory above 48 KiB must be asked for; then the grid is
// every block that fits on the card at once (a persistent grid).
template <typename Kernel>
static int resident_blocks(Kernel kernel, size_t smem, int* blocks) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int dev = 0, sms = 0, per_sm = 0;
    if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GS_THREADS, smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    *blocks = per_sm * sms;
    return 0;
}

template <int G>
static int launch_small(const int* dense, const VecPtrs& ptrs, long long n, int k,
                        int nseg, u64* out, cudaStream_t stream) {
    const size_t smem = (size_t)GS_WARPS * (nseg + 1) * G * 32 * sizeof(u64);
    if (smem > GS_SMEM_MAX) return (int)cudaErrorInvalidValue;
    int blocks = 0;
    const int err = resident_blocks(grouped_sum_small<G>, smem, &blocks);
    if (err) return err;
    const int groups = (k + G - 1) / G;
    const long long tiles_x = (n / GS_TILE + GS_WARPS - 1) / GS_WARPS;
    long long x = blocks / groups;
    if (x > tiles_x) x = tiles_x;
    if (x < 1) x = 1;
    grouped_sum_small<G><<<dim3((unsigned)x, groups), GS_THREADS, smem, stream>>>(
        dense, ptrs, n, k, nseg, out);
    return (int)cudaGetLastError();
}

static int launch_large(const int* dense, const VecPtrs& ptrs, long long n, int k,
                        int nseg, u64* out, cudaStream_t stream) {
    const size_t smem = (size_t)nseg * (k | 1) * sizeof(u64);
    if (smem > GS_SMEM_MAX) return (int)cudaErrorInvalidValue;
    int blocks = 0;
    const int err = resident_blocks(grouped_sum_large, smem, &blocks);
    if (err) return err;
    const long long need = (n + GS_THREADS - 1) / GS_THREADS;
    const long long x = need < blocks ? (need < 1 ? 1 : need) : blocks;
    grouped_sum_large<<<(unsigned)x, GS_THREADS, smem, stream>>>(
        dense, ptrs, n, k, nseg, out);
    return (int)cudaGetLastError();
}

// dense: (n,) int32 slot ids; vec_ptrs: k device pointers to (n,) int64;
// dense and every vector 16-byte aligned. out: zeroed (nseg, k) int64.
// group: 1, 2 or 4 takes the small regime with tables of that many
// vectors, 0 the large regime. Returns a CUDA error code, 0 after a launch
// that was accepted.
extern "C" int grouped_sum_i64(const void* dense, const void* const* vec_ptrs,
                               long long n, int k, int nseg, void* out,
                               int group, void* stream) {
    if (k < 1 || k > GS_MAX_K || nseg < 1 || n < 0) return (int)cudaErrorInvalidValue;
    VecPtrs ptrs;
    for (int j = 0; j < GS_MAX_K; ++j)
        ptrs.p[j] = j < k ? (const long long*)vec_ptrs[j] : nullptr;
    const int* d = (const int*)dense;
    u64* o = (u64*)out;
    cudaStream_t s = (cudaStream_t)stream;
    switch (group) {
        case 0: return launch_large(d, ptrs, n, k, nseg, o, s);
        case 1: return launch_small<1>(d, ptrs, n, k, nseg, o, s);
        case 2: return launch_small<2>(d, ptrs, n, k, nseg, o, s);
        case 4: return launch_small<4>(d, ptrs, n, k, nseg, o, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
