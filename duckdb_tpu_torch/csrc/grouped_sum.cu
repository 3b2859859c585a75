// Exact per-slot int64 sums of K pre-masked vectors, keyed by dense slot ids.
//
// Replaces the Pallas kernel duckdb_tpu/ops/pallas_agg.py:_kernel (launched
// by grouped_sum_i64). That kernel splits every int64 into 8-bit limbs and
// sums them on the TPU's matrix unit because the v5e has no 64-bit
// datapath. Hopper adds int64 natively, so none of that carries over, and
// the tensor cores have nothing to take: the work is one add per value.
//
// Bound on this card: memory. The kernel reads every slot id once and the
// K values of live rows once, and does K adds per live row, far below the
// card's integer rate; at 3.35 TB/s the bytes set the floor. Slot ids are
// int32 or int64 (a template on the id type: no conversion pass), and ids
// outside [0, nseg) are dead: they add nothing whatever their values hold,
// and a value that only dead rows need is never read. Three regimes, chosen
// by the wrapper from n, nseg and K; each call is one launch that writes
// every output cell itself, so the output needs no fill:
//
// * small (nseg + 1 slot rows fit two blocks' tables on an SM): no
//   atomics in the row loop. Each warp owns a lane-private table in shared
//   memory: cell (slot s, vector g) of lane l is acc[(s * G + g) * 32 + l].
//   A lane adds its rows with plain load-add-store into its own column, so
//   no two lanes share a word and a warp's 32 accesses take 2 wavefronts,
//   the least for 64-bit words, whatever the ids. Dead ids go to a spare
//   row nseg, so the add has no branch. A table holds G vectors;
//   blockIdx.y picks the block's group of G. Each lane holds four
//   consecutive rows: their ids in one 16-byte load (two for int64 ids)
//   and, for each vector, the 32 bytes of their values, which it loads only
//   if one of the four rows is live: a 32-byte sector that only dead rows
//   use is never read. Ids run two tiles ahead and values one, so the value
//   loads of the next tile go out, chosen by ids already in registers,
//   before the adds of this one. The 16-byte loads start at the first row
//   where every pointer sits on a 16-byte boundary (a view at a row
//   offset, as a chunk of a larger column, shares one such row); the rows
//   before it and after the last whole tile are added one by one. Where no
//   row aligns every pointer, a variant loads 8 bytes at a time. A block
//   zeroes and folds only the tables of the warps that get a tile.
// * single (the small regime's domains, n at most a threshold measured on
//   the card): the same kernel with one block per group of G vectors. That
//   block owns its group's output cells, so it stores each once: nothing
//   to zero, no global atomics, nothing to wait for.
// * large (up to 256 slots and beyond): one (nseg, K) table per block with
//   rows K | 1 words long (an even length puts every slot's row on the same
//   bank). Lanes of a warp that hold the same slot id find each other with
//   __match_any_sync and sum their K values with a log-step shuffle tree;
//   only the lowest lane of each group does the K shared atomics. A warp
//   whose 32 rows all fall in one slot does K atomics instead of 32 K, and
//   a warp whose 32 rows are all dead loads no value at all. Each 64-bit
//   add is two native 32-bit shared atomics (add_u64_shared): on this card
//   the 64-bit shared atomicAdd is a compare-and-swap loop.
//
// The small and large regimes run a persistent grid sized by the occupancy
// calculator (launched cooperatively, so that every block is resident).
// Its blocks add their tables into the output with one global atomic a
// cell, so block 0 zeroes the output first thing and raises a flag; each
// other block waits for the flag only before its flush, long after block 0
// raised it, and the last block to see it lowers it again (the flag and its
// count are two words kept per stream, cleared once when a stream first
// needs them). A grid of one block in x stores its cells as the single
// regime does. The occupancy answers are cached per (kernel, shared
// bytes, device), so only a call's first launch of a configuration asks
// the runtime.
//
// Unsigned addition wraps mod 2^64 and is associative, so the result is
// bit-identical to a sequential int64 sum whatever order anything lands in.
// The lane-private tables and the warp intrinsics are why this is CUDA C++
// and not Triton: Triton has no per-lane addressing of shared memory.
//
// Build (plain C interface, loaded with ctypes):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC

#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

#define GS_MAX_K 24
#define GS_WARPS 8
#define GS_THREADS (GS_WARPS * 32)
#define GS_LANE_ROWS 4                      // rows per lane per tile (16-byte id load)
#define GS_TILE (32 * GS_LANE_ROWS)         // rows per warp per tile
#define GS_SMEM_MAX 232448                  // opt-in shared memory of one block
#define GS_FULL 0xffffffffu

typedef unsigned long long u64;

struct VecPtrs {
    const long long* p[GS_MAX_K];
};

__device__ __forceinline__ u64 warp_sum(u64 x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(GS_FULL, x, o);
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

// The slot of an id, nseg (the spare row) for a dead one.
__device__ __forceinline__ int slot_of(int id, int nseg) {
    return (unsigned)id < (unsigned)nseg ? id : nseg;
}
__device__ __forceinline__ int slot_of(long long id, int nseg) {
    return (unsigned long long)id < (unsigned long long)nseg ? (int)id : nseg;
}

// Slots of the four rows at row (16-byte loads when V16: row's id and
// value addresses are 16-byte aligned).
template <bool V16>
__device__ __forceinline__ int4 slots4(const int* __restrict__ d, long long row, int nseg) {
    int4 id;
    if (V16) {
        id = __ldg(reinterpret_cast<const int4*>(d + row));
    } else {
        id.x = __ldg(d + row);
        id.y = __ldg(d + row + 1);
        id.z = __ldg(d + row + 2);
        id.w = __ldg(d + row + 3);
    }
    return make_int4(slot_of(id.x, nseg), slot_of(id.y, nseg), slot_of(id.z, nseg),
                     slot_of(id.w, nseg));
}
template <bool V16>
__device__ __forceinline__ int4 slots4(const long long* __restrict__ d, long long row,
                                       int nseg) {
    longlong2 a, b;
    if (V16) {
        a = __ldg(reinterpret_cast<const longlong2*>(d + row));
        b = __ldg(reinterpret_cast<const longlong2*>(d + row + 2));
    } else {
        a.x = __ldg(d + row);
        a.y = __ldg(d + row + 1);
        b.x = __ldg(d + row + 2);
        b.y = __ldg(d + row + 3);
    }
    return make_int4(slot_of(a.x, nseg), slot_of(a.y, nseg), slot_of(b.x, nseg),
                     slot_of(b.y, nseg));
}

template <bool V16>
__device__ __forceinline__ void values4(const long long* __restrict__ p, long long row,
                                        longlong2& a, longlong2& b) {
    if (V16) {
        a = __ldg(reinterpret_cast<const longlong2*>(p + row));
        b = __ldg(reinterpret_cast<const longlong2*>(p + row + 2));
    } else {
        a.x = __ldg(p + row);
        a.y = __ldg(p + row + 1);
        b.x = __ldg(p + row + 2);
        b.y = __ldg(p + row + 3);
    }
}

__device__ __forceinline__ bool any_live(int4 s, int nseg) {
    return s.x < nseg || s.y < nseg || s.z < nseg || s.w < nseg;
}

// A grid of more than one block per group of vectors: block 0 zeroes the
// output and raises state[0] with a release store; every other block
// waits for it with acquire loads before its flush (the pattern of
// CUTLASS's generic barrier: a block barrier, then one thread releases or
// acquires at the card's scope); state[1] counts the blocks that have seen
// the flag, and the last one lowers both words for the stream's next
// launch.
__device__ __forceinline__ void store_release(u64* p, u64 v) {
    asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ u64 load_acquire(const u64* p) {
    u64 v;
    asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void zero_output(u64* __restrict__ out, long long cells,
                                            u64* state) {
    for (long long i = threadIdx.x; i < cells; i += GS_THREADS) out[i] = 0ULL;
    __syncthreads();
    if (threadIdx.x == 0) store_release(state, 1ULL);
}

__device__ __forceinline__ void await_zeroed(u64* state) {
    if (threadIdx.x == 0) {
        while (load_acquire(state) == 0ULL) __nanosleep(32);
        const u64 blocks = (u64)gridDim.x * gridDim.y;
        if (atomicAdd(state + 1, 1ULL) == blocks - 1ULL) {  // the last to see it
            state[0] = 0ULL;
            state[1] = 0ULL;
        }
    }
    __syncthreads();
}

template <int G, typename I, bool V16>
__global__ void __launch_bounds__(GS_THREADS)
grouped_sum_small(const I* __restrict__ dense, VecPtrs vecs, long long n, int k, int nseg,
                  int head, u64* __restrict__ out, u64* state) {
    extern __shared__ u64 acc[];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int warp_cells = (nseg + 1) * G;  // one warp's cells, spare row included
    // whole tiles cover [head, tail); the rows around them go one by one
    const long long ntiles = (n - head) / GS_TILE;
    const long long tail = head + ntiles * GS_TILE;
    // warps of this block that get a tile: fewer than all only at the end
    // of a small input, whose other warps' tables are neither zeroed nor
    // folded (warp 0 always: block 0's takes the ragged rows)
    const int used = (int)max(1LL, min((long long)GS_WARPS,
                                       ntiles - (long long)blockIdx.x * GS_WARPS));
    for (int i = threadIdx.x; i < used * warp_cells * 32; i += GS_THREADS) acc[i] = 0ULL;
    const bool one = gridDim.x == 1;  // this block owns its group's cells
    if (!one && blockIdx.x == 0 && blockIdx.y == 0) zero_output(out, (long long)nseg * k, state);
    __syncthreads();

    const int g0 = blockIdx.y * G;
    const int gk = min(G, k - g0);  // vectors of this block's group
    const long long* p[G];
#pragma unroll
    for (int g = 0; g < G; ++g) p[g] = vecs.p[g < gk ? g0 + g : g0];
    u64* mine = acc + warp * warp_cells * 32 + lane;

    const long long nw = (long long)gridDim.x * GS_WARPS;
    const long long lane_row = head + lane * GS_LANE_ROWS;
    const int4 dead = make_int4(nseg, nseg, nseg, nseg);
    auto slots_at = [&](long long tile) {
        return tile < ntiles ? slots4<V16>(dense, tile * GS_TILE + lane_row, nseg) : dead;
    };
    // ids two tiles ahead, values one, each tile's values loaded only where
    // its ids hold a live row. (Deeper rings of ids, in registers or in
    // shared memory by bulk asynchronous copies, were slower on sparse
    // inputs and no faster on dense ones.)
    long long t = (long long)blockIdx.x * GS_WARPS + warp;
    int4 cur = slots_at(t), nxt = slots_at(t + nw);
    longlong2 va[G], vb[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
        va[g] = vb[g] = make_longlong2(0, 0);
        if (g < gk && any_live(cur, nseg)) values4<V16>(p[g], t * GS_TILE + lane_row, va[g], vb[g]);
    }
    while (t < ntiles) {
        const long long tn = t + nw;
        const int4 after = slots_at(tn + nw);
        longlong2 na[G], nb[G];
        const bool load = any_live(nxt, nseg);  // false past the last tile: dead ids
#pragma unroll
        for (int g = 0; g < G; ++g) {
            na[g] = nb[g] = make_longlong2(0, 0);
            if (g < gk && load) values4<V16>(p[g], tn * GS_TILE + lane_row, na[g], nb[g]);
        }
        if (any_live(cur, nseg)) {
            const int c0 = cur.x * G, c1 = cur.y * G, c2 = cur.z * G, c3 = cur.w * G;
#pragma unroll
            for (int g = 0; g < G; ++g) {
                if (g < gk) {
                    mine[(c0 + g) * 32] += (u64)va[g].x;
                    mine[(c1 + g) * 32] += (u64)va[g].y;
                    mine[(c2 + g) * 32] += (u64)vb[g].x;
                    mine[(c3 + g) * 32] += (u64)vb[g].y;
                }
            }
        }
        cur = nxt;
        nxt = after;
#pragma unroll
        for (int g = 0; g < G; ++g) {
            va[g] = na[g];
            vb[g] = nb[g];
        }
        t = tn;
    }
    if (blockIdx.x == 0 && warp == 0) {  // the head rows, then the ragged tail
        for (long long i = lane; i < head + (n - tail); i += 32) {
            const long long row = i < head ? i : tail + (i - head);
            const int s = slot_of(dense[row], nseg);
            if (s < nseg) {
#pragma unroll
                for (int g = 0; g < G; ++g)
                    if (g < gk) mine[(s * G + g) * 32] += (u64)p[g][row];
            }
        }
    }

    // fold: one warp per (slot, vector) cell, lane l sums column l over the
    // block's used warps, then the warp sums its lanes; the spare row is
    // skipped
    auto fold = [&](int c) {
        u64 s = 0ULL;
#pragma unroll
        for (int w = 0; w < GS_WARPS; ++w)
            if (w < used) s += acc[(w * warp_cells + c) * 32 + lane];
        return warp_sum(s);
    };
    if (one) {  // each cell stored once, zero or not
        __syncthreads();
        for (int c = warp; c < nseg * G; c += GS_WARPS) {
            const u64 s = fold(c);
            const int g = c % G;
            if (lane == 0 && g < gk) out[(long long)(c / G) * k + g0 + g] = s;
        }
    } else {
        await_zeroed(state);
        for (int c = warp; c < nseg * G; c += GS_WARPS) {
            const u64 s = fold(c);
            const int g = c % G;
            if (lane == 0 && g < gk && s != 0ULL) atomicAdd(out + (long long)(c / G) * k + g0 + g, s);
        }
    }
}

// Adds the warp's 32 rows (slot s and values v[0..kl) of each lane, s ==
// nseg and v zero for a dead lane) into the block's (nseg, ks) table: the
// lanes of one slot sum into their lowest lane, which does the atomics.
__device__ __forceinline__ void add_warp_rows(u64* __restrict__ acc, int ks, int kl, int nseg,
                                              int s, u64 (&v)[GS_MAX_K]) {
    const int lane = threadIdx.x & 31;
    const unsigned below = (1u << lane) - 1u;     // lanes under this one
    const unsigned above = ~((2u << lane) - 1u);  // lanes over this one
    // step i adds the value of the next remaining peer, then drops the
    // peers whose rank has bit i set (they were summed in this step)
    const unsigned group = __match_any_sync(GS_FULL, s);
    unsigned rank = __popc(group & below);
    unsigned peers = group & above;
    while (__any_sync(GS_FULL, peers != 0u)) {
        const int next = __ffs(peers);  // 1 + the next peer's lane, 0 if none
        const int src = next ? next - 1 : lane;
#pragma unroll
        for (int j = 0; j < GS_MAX_K; ++j) {
            if (j < kl) {
                const u64 t = __shfl_sync(GS_FULL, v[j], src);
                if (next) v[j] += t;
            }
        }
        peers &= ~__ballot_sync(GS_FULL, rank & 1u);
        rank >>= 1;
    }
    if ((group & below) == 0u && s < nseg) {
        u64* a = acc + s * ks;
#pragma unroll
        for (int j = 0; j < GS_MAX_K; ++j)
            if (j < kl) add_u64_shared(a + j, v[j]);
    }
}

// The large regime: a cooperative persistent grid, one row per lane per
// step; a warp whose 32 rows are all dead reads no value.
template <typename I>
__global__ void __launch_bounds__(GS_THREADS)
grouped_sum_large(const I* __restrict__ dense, VecPtrs vecs, long long n, int k, int nseg,
                  u64* __restrict__ out, u64* state) {
    extern __shared__ u64 acc[];
    const int ks = k | 1;  // row length of the table: odd, see above
    const int cells = nseg * ks;
    for (int i = threadIdx.x; i < cells; i += GS_THREADS) acc[i] = 0ULL;
    const bool one = gridDim.x == 1;  // this block owns every cell
    if (!one && blockIdx.x == 0) zero_output(out, (long long)nseg * k, state);
    __syncthreads();

    const int lane = threadIdx.x & 31;
    const long long stride = (long long)gridDim.x * GS_WARPS * 32;
    for (long long base = ((long long)blockIdx.x * GS_WARPS + (threadIdx.x >> 5)) * 32;
         base < n; base += stride) {
        const long long row = base + lane;
        const int s = row < n ? slot_of(__ldg(dense + row), nseg) : nseg;
        if (!__any_sync(GS_FULL, s < nseg)) continue;  // 32 dead rows: no value read
        u64 v[GS_MAX_K];
#pragma unroll
        for (int j = 0; j < GS_MAX_K; ++j)
            v[j] = (j < k && s < nseg) ? (u64)__ldg(vecs.p[j] + row) : 0ULL;
        add_warp_rows(acc, ks, k, nseg, s, v);
    }
    if (one) {
        __syncthreads();
        for (int i = threadIdx.x; i < cells; i += GS_THREADS) {
            const int s = i / ks, j = i - s * ks;
            if (j < k) out[(long long)s * k + j] = acc[i];
        }
        return;
    }
    await_zeroed(state);
    for (int i = threadIdx.x; i < cells; i += GS_THREADS) {
        const int s = i / ks, j = i - s * ks;
        const u64 v = acc[i];
        if (j < k && v != 0ULL) atomicAdd(out + (long long)s * k + j, v);
    }
}

// Dynamic shared memory above 48 KiB must be asked for (each kernel asks
// for the most a block may have, once); the persistent grid is every block
// that fits on the card at once. The answers are cached per (kernel, shared
// bytes, device).
struct Config {
    int err;
    int blocks;  // resident blocks on the card
};
static std::mutex config_mu;
static std::map<std::tuple<const void*, size_t, int>, Config> configs;
// per (device, stream): the two words of a persistent grid's zero flag
static std::map<std::pair<int, cudaStream_t>, u64*> states;

template <typename Kernel>
static Config resident_blocks(Kernel kernel, size_t smem, int dev) {
    const auto key = std::make_tuple((const void*)kernel, smem, dev);
    {
        std::lock_guard<std::mutex> hold(config_mu);
        const auto it = configs.find(key);
        if (it != configs.end()) return it->second;
    }
    Config c = {0, 0};
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, GS_SMEM_MAX);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, GS_THREADS, smem);
    if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
    if (err != cudaSuccess) return Config{(int)err, 0};
    c.blocks = per_sm * sms;
    std::lock_guard<std::mutex> hold(config_mu);
    configs[key] = c;
    return c;
}

// The stream's zero flag, made and cleared (in stream order) the first
// time a persistent grid runs on it: launches on one stream run one after
// another, and each leaves the flag lowered.
static int stream_state(int dev, cudaStream_t stream, u64** state) {
    std::lock_guard<std::mutex> hold(config_mu);
    const auto key = std::make_pair(dev, stream);
    const auto it = states.find(key);
    if (it != states.end()) {
        *state = it->second;
        return 0;
    }
    u64* p = nullptr;
    cudaError_t err = cudaMalloc(&p, 2 * sizeof(u64));
    if (err != cudaSuccess) return (int)err;
    err = cudaMemsetAsync(p, 0, 2 * sizeof(u64), stream);
    if (err != cudaSuccess) {
        cudaFree(p);
        return (int)err;
    }
    states[key] = p;
    *state = p;
    return 0;
}

// One launch; a grid of more than one block per group of vectors is
// cooperative (all resident: its blocks wait on block 0's flag) and gets
// the stream's flag, a grid of one block per group none.
template <typename Kernel, typename... Args>
static int launch(Kernel kernel, dim3 grid, size_t smem, int dev, cudaStream_t stream,
                  Args... args) {
    u64* state = nullptr;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    cfg.gridDim = grid;
    cfg.blockDim = dim3(GS_THREADS, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    if (grid.x > 1) {
        const int err = stream_state(dev, stream, &state);
        if (err) return err;
        attr[0].id = cudaLaunchAttributeCooperative;
        attr[0].val.cooperative = 1;
        cfg.attrs = attr;
        cfg.numAttrs = 1;
    }
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args..., state);
    return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

// The first row at which the ids and every vector sit on a 16-byte
// boundary, or -1 when no row of the first four aligns them all.
static int common_head(const void* dense, int id_bytes, const VecPtrs& ptrs, int k,
                       long long n) {
    for (int h = 0; h < GS_LANE_ROWS && h <= n; ++h) {
        bool ok = ((uintptr_t)dense + (uintptr_t)h * id_bytes) % 16 == 0;
        for (int j = 0; j < k && ok; ++j) ok = ((uintptr_t)(ptrs.p[j] + h)) % 16 == 0;
        if (ok) return h;
    }
    return -1;
}

// The lane-private tables: a persistent grid (small) or one block per
// group of G vectors (single).
template <int G, typename I, bool V16>
static int launch_small(const I* dense, const VecPtrs& ptrs, long long n, int k, int nseg,
                        int head, bool single, u64* out, int dev, cudaStream_t stream) {
    const size_t smem = (size_t)GS_WARPS * (nseg + 1) * G * 32 * sizeof(u64);
    if (smem > GS_SMEM_MAX) return (int)cudaErrorInvalidValue;
    auto kernel = grouped_sum_small<G, I, V16>;
    const Config c = resident_blocks(kernel, smem, dev);
    if (c.err) return c.err;
    const int groups = (k + G - 1) / G;
    long long x = 1;
    if (!single) {
        const long long tiles_x = ((n - head) / GS_TILE + GS_WARPS - 1) / GS_WARPS;
        x = c.blocks / groups;
        if (x > tiles_x) x = tiles_x;
        if (x < 1) x = 1;
    }
    return launch(kernel, dim3((unsigned)x, groups, 1), smem, dev, stream, dense, ptrs, n, k,
                  nseg, head, out);
}

template <int G, typename I>
static int launch_small_any(const I* dense, int id_bytes, const VecPtrs& ptrs, long long n,
                            int k, int nseg, bool single, u64* out, int* narrow, int dev,
                            cudaStream_t stream) {
    const int head = common_head(dense, id_bytes, ptrs, k, n);
    *narrow = head < 0;
    if (head < 0)
        return launch_small<G, I, false>(dense, ptrs, n, k, nseg, 0, single, out, dev, stream);
    return launch_small<G, I, true>(dense, ptrs, n, k, nseg, head, single, out, dev, stream);
}

template <typename I>
static int launch_large(const I* dense, const VecPtrs& ptrs, long long n, int k, int nseg,
                        u64* out, int dev, cudaStream_t stream) {
    const size_t smem = (size_t)nseg * (k | 1) * sizeof(u64);
    if (smem > GS_SMEM_MAX) return (int)cudaErrorInvalidValue;
    auto kernel = grouped_sum_large<I>;
    const Config c = resident_blocks(kernel, smem, dev);
    if (c.err) return c.err;
    const long long need = (n + GS_THREADS - 1) / GS_THREADS;
    const long long x = need < c.blocks ? (need < 1 ? 1 : need) : c.blocks;
    return launch(kernel, dim3((unsigned)x, 1, 1), smem, dev, stream, dense, ptrs, n, k, nseg,
                  out);
}

template <typename I>
static int dispatch(const I* d, int id_bytes, const VecPtrs& ptrs, long long n, int k,
                    int nseg, u64* out, int regime, int group, int* narrow, int dev,
                    cudaStream_t s) {
    if (regime == 0) return launch_large(d, ptrs, n, k, nseg, out, dev, s);
    if (regime != 1 && regime != 2) return (int)cudaErrorInvalidValue;
    const bool single = regime == 2;
    switch (group) {
        case 1: return launch_small_any<1, I>(d, id_bytes, ptrs, n, k, nseg, single, out, narrow, dev, s);
        case 2: return launch_small_any<2, I>(d, id_bytes, ptrs, n, k, nseg, single, out, narrow, dev, s);
        case 4: return launch_small_any<4, I>(d, id_bytes, ptrs, n, k, nseg, single, out, narrow, dev, s);
        default: return (int)cudaErrorInvalidValue;
    }
}

// dense: (n,) slot ids of id_bytes (4: int32, 8: int64); vec_ptrs: k
// device pointers to (n,) int64; every pointer aligned to its element.
// out: (nseg, k) int64, written whole by the launch (no fill needed).
// regime 0: large; 1: small, the lane-private tables of `group` (1, 2 or
// 4) vectors on a persistent grid; 2: single, the same tables in one block
// per group. device: the current CUDA device's index. *narrow is set to 1
// where the lane-private tables' loads took 8 bytes at a time (no row
// aligns every pointer to 16 bytes), else 0. Returns a CUDA error code, 0
// after a launch that was accepted.
extern "C" int grouped_sum_i64(const void* dense, int id_bytes, const void* const* vec_ptrs,
                               long long n, int k, int nseg, void* out, int regime,
                               int group, int device, void* stream, int* narrow) {
    *narrow = 0;
    if (k < 1 || k > GS_MAX_K || nseg < 1 || n < 0 || (id_bytes != 4 && id_bytes != 8))
        return (int)cudaErrorInvalidValue;
    VecPtrs ptrs;
    for (int j = 0; j < GS_MAX_K; ++j) {
        ptrs.p[j] = j < k ? (const long long*)vec_ptrs[j] : nullptr;
        if (j < k && (uintptr_t)ptrs.p[j] % 8) return (int)cudaErrorMisalignedAddress;
    }
    if ((uintptr_t)dense % id_bytes) return (int)cudaErrorMisalignedAddress;
    u64* o = (u64*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (id_bytes == 4)
        return dispatch((const int*)dense, 4, ptrs, n, k, nseg, o, regime, group, narrow,
                        device, s);
    return dispatch((const long long*)dense, 8, ptrs, n, k, nseg, o, regime, group, narrow,
                    device, s);
}
