// One-token decode attention over a ring-buffer KV cache, split across
// blocks (flash-decoding).
//
// swa_decode_kernel replaces the Pallas TPU kernel swa_decode_tiled
// (_kernel) of src/repro/kernels/swa_decode/kernel.py.  For each batch row
// b and KV head h, with the G query heads of that KV head (q pre-scaled
// by dh^-0.5):
//   out[b, h, g] = sum_s softmax_s(q[b, h, g] . k[b, s, h]) v[b, s, h]
// over the slots s whose absolute position p = pos[s] is valid:
// 0 <= p <= qpos, and p > qpos - window when a window is set.  As in the
// TPU kernel, an invalid slot's score is -1e30 and its probability is
// forced to 0, and the output is acc / max(l, 1e-30).
//
// What bounds it on this card: device memory.  Each cached K and V value
// is read once and used for G multiply-adds (G = 4 for gemma3's MQA), far
// below the card's balance point: 2*B*W*Hkv*dh*4 bytes per call.  With
// gemma3's single KV head one block per (b, h) would leave all but B of
// the 132 SMs idle, and the memory system with them.
//
// Design: the grid is (B Hkv, nsplit).  Block j of (b, h) walks the
// contiguous slots [j per, (j + 1) per), per = ceil(W / nsplit); the
// wrapper picks nsplit for about two blocks per SM, splits of a multiple
// of 32 slots (one step of the block's warps) and at least 32, and 1 when
// W is small.  Within a block, 8 warps take U slots at a
// time (the K and V rows of those U slots are loaded together, 16 bytes a
// lane, and the positions of the next U slots are read a step ahead), and
// each keeps its own running max m, normaliser l and [G, dh] accumulator
// in registers: lane L holds the columns 4 (L + 32 j) .. 4 (L + 32 j) + 3
// of every row, and a warp's dot products end in a butterfly of shuffles
// that leaves the same sum on every lane.  The scores are kept in base 2
// (q times log2 e), so each weight is one exp2f, and the products are
// explicit fmaf: a block's time is mostly its own arithmetic and latency,
// not its bytes.  Slots whose position is
// invalid are not read.  The warps' states are merged through shared
// memory, warp by warp in order.  With nsplit = 1 that is the output; otherwise
// each block writes its (m, l, acc) to the wrapper's scratch, and the last
// block of (b, h) to finish (it learns so from __threadfence() and an
// atomic counter, which it resets to 0 for the next launch) merges the
// nsplit partials in split order: M = max_j m_j, out = sum_j acc_j
// 2^(m_j - M) / max(sum_j l_j 2^(m_j - M), 1e-30).  A split without a
// valid slot has m = -1e30 and l = acc = 0 and contributes nothing; with
// none at all the output is 0.  One launch per layer; no float atomics,
// so the result is the same from run to run.  Template parameters fix
// the register arrays: Q float4 column groups per lane (dh <= 128 Q) and
// MAXG query rows (G <= MAXG); the launcher rounds both up to powers of
// two.  Any W and dh <= 256 work (16-byte loads when dh % 4 == 0).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxSplit = 64;
constexpr int kBatch = 8;                      // partials whose loads fly together
constexpr float kNegInf = -1e30f;
// scores are kept in base 2 (q scaled by log2 e in shared memory), so that
// each softmax weight is one exp2f
constexpr float kLog2e = 1.4426950408889634f;

template <int Q, int MAXG>
__global__ void __launch_bounds__(kThreads)
    swa_decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const int* __restrict__ pos,
                      float* __restrict__ out, float* __restrict__ part,
                      int* __restrict__ counter, int w, int hkv, int g, int dh,
                      int per, long long qpos, long long window, bool vec) {
  constexpr int kCols = 128 * Q;
  constexpr int D = 4 * Q;                       // columns per lane
  constexpr int U = (MAXG * Q > 8) ? 2 : 4;      // slots per warp step
  // q (times log2 e) in buf[0] during the slot loop; then four warps'
  // scaled accumulators at a time
  __shared__ __align__(16) float buf[4][MAXG][kCols];
  float (*sq)[kCols] = buf[0];
  __shared__ float sm[kWarps][MAXG];
  __shared__ float sl[kWarps][MAXG];
  __shared__ float s_m[MAXG];
  __shared__ float s_l[MAXG];
  __shared__ float s_pm[kMaxSplit][MAXG];       // the partials' m, then scales
  __shared__ float s_pl[kMaxSplit][MAXG];
  __shared__ bool s_last;

  const int bh = blockIdx.x;                    // b * hkv + h
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int b = bh / hkv;
  const int h = bh - b * hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s_begin = split * per;
  const int s_end = min(w, s_begin + per);

  // the positions of the warp's next U slots are read one step ahead, so
  // that the K/V loads do not wait on them (-1 past the split: invalid);
  // the first ones while q comes in
  int pnext[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int s = s_begin + warp * U + u;
    pnext[u] = s < s_end ? pos[s] : -1;
  }
  const float* qbh = q + (long long)bh * g * dh;
  if (vec) {
    for (int i = threadIdx.x; i < MAXG * kCols / 4; i += kThreads) {
      const int gi = 4 * i / kCols;
      const int d = 4 * i - gi * kCols;
      const float4 qv = (gi < g && d < dh)
                            ? *reinterpret_cast<const float4*>(qbh + gi * dh + d)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      *reinterpret_cast<float4*>(&sq[gi][d]) =
          make_float4(qv.x * kLog2e, qv.y * kLog2e, qv.z * kLog2e, qv.w * kLog2e);
    }
  } else {
    for (int i = threadIdx.x; i < MAXG * kCols; i += kThreads) {
      const int gi = i / kCols;
      const int d = i - gi * kCols;
      sq[gi][d] = (gi < g && d < dh) ? qbh[gi * dh + d] * kLog2e : 0.0f;
    }
  }
  __syncthreads();

  // the K/V row of slot s starts at ((b * w + s) * hkv + h) * dh
  const long long row_stride = (long long)hkv * dh;
  const float* kb = k + ((long long)b * w * hkv + h) * dh;
  const float* vb = v + ((long long)b * w * hkv + h) * dh;

  float m[MAXG], l[MAXG], acc[MAXG][D];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.0f;
#pragma unroll
    for (int j = 0; j < D; ++j) acc[gi][j] = 0.0f;
  }

  for (int base = s_begin + warp * U; base < s_end; base += kWarps * U) {
    bool ok[U];
    bool any = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long p = pnext[u];
      ok[u] = p >= 0 && p <= qpos && (window < 0 || p > qpos - window);
      any = any || ok[u];
      const int s = base + kWarps * U + u;
      pnext[u] = s < s_end ? pos[s] : -1;
    }
    // the same on every lane: a step with no valid slot changes nothing
    if (!any) continue;
    float kr[U][D], vr[U][D];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long off = (long long)(base + u) * row_stride;
#pragma unroll
      for (int j = 0; j < Q; ++j) {
        const int c0 = 4 * (lane + 32 * j);
        if (vec) {
          float4 kv = make_float4(0.0f, 0.0f, 0.0f, 0.0f), vv = kv;
          if (ok[u] && c0 < dh) {
            kv = *reinterpret_cast<const float4*>(kb + off + c0);
            vv = *reinterpret_cast<const float4*>(vb + off + c0);
          }
          kr[u][4 * j] = kv.x; kr[u][4 * j + 1] = kv.y;
          kr[u][4 * j + 2] = kv.z; kr[u][4 * j + 3] = kv.w;
          vr[u][4 * j] = vv.x; vr[u][4 * j + 1] = vv.y;
          vr[u][4 * j + 2] = vv.z; vr[u][4 * j + 3] = vv.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const bool load = ok[u] && c0 + e < dh;
            kr[u][4 * j + e] = load ? kb[off + c0 + e] : 0.0f;
            vr[u][4 * j + e] = load ? vb[off + c0 + e] : 0.0f;
          }
        }
      }
    }
    float sc[U][MAXG];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) sc[u][gi] = 0.0f;
#pragma unroll
    for (int j = 0; j < Q; ++j) {
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi) {
        const float4 qv =
            *reinterpret_cast<const float4*>(&sq[gi][4 * (lane + 32 * j)]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sc[u][gi] = fmaf(qv.x, kr[u][4 * j], sc[u][gi]);
          sc[u][gi] = fmaf(qv.y, kr[u][4 * j + 1], sc[u][gi]);
          sc[u][gi] = fmaf(qv.z, kr[u][4 * j + 2], sc[u][gi]);
          sc[u][gi] = fmaf(qv.w, kr[u][4 * j + 3], sc[u][gi]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          sc[u][gi] += __shfl_xor_sync(0xffffffffu, sc[u][gi], o);

#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      float mx = m[gi];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (ok[u]) mx = fmaxf(mx, sc[u][gi]);
      const float alpha = exp2f(m[gi] - mx);
      float p[U];
      float psum = 0.0f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u] = ok[u] ? exp2f(sc[u][gi] - mx) : 0.0f;
        psum += p[u];
      }
      l[gi] = fmaf(l[gi], alpha, psum);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float pv = acc[gi][j] * alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) pv = fmaf(p[u], vr[u][j], pv);
        acc[gi][j] = pv;
      }
      m[gi] = mx;
    }
  }

  // merge the warps' states: the block-wide max M, each warp's accumulator
  // scaled by 2^(m_w - M) and summed warp by warp in order, four warps at a
  // time through shared memory (q's buffer, done with); thread i keeps the
  // sums of the float4 groups i, i + kThreads, ... in registers
  if (lane == 0) {
#pragma unroll
    for (int gi = 0; gi < MAXG; ++gi) {
      sm[warp][gi] = m[gi];
      sl[warp][gi] = l[gi];
    }
  }
  __syncthreads();
  float scale[MAXG];
#pragma unroll
  for (int gi = 0; gi < MAXG; ++gi) {
    float mx = sm[0][gi];
    for (int wi = 1; wi < kWarps; ++wi) mx = fmaxf(mx, sm[wi][gi]);
    scale[gi] = exp2f(m[gi] - mx);
    if (threadIdx.x == gi) {
      float norm = 0.0f;
      for (int wi = 0; wi < kWarps; ++wi)
        norm += sl[wi][gi] * exp2f(sm[wi][gi] - mx);
      s_m[gi] = mx;
      s_l[gi] = norm;
    }
  }
  constexpr int kGroups = MAXG * kCols / 4;      // float4 groups of [MAXG][kCols]
  constexpr int kMine = (kGroups + kThreads - 1) / kThreads;
  float4 tot[kMine];
  for (int half = 0; half < 2; ++half) {
    if (warp / 4 == half) {
#pragma unroll
      for (int gi = 0; gi < MAXG; ++gi)
#pragma unroll
        for (int j = 0; j < Q; ++j)
          *reinterpret_cast<float4*>(&buf[warp % 4][gi][4 * (lane + 32 * j)]) =
              make_float4(acc[gi][4 * j] * scale[gi], acc[gi][4 * j + 1] * scale[gi],
                          acc[gi][4 * j + 2] * scale[gi], acc[gi][4 * j + 3] * scale[gi]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      const int grp = threadIdx.x + i * kThreads;
      if (grp >= kGroups) break;
#pragma unroll
      for (int w4 = 0; w4 < 4; ++w4) {
        const float4 part_w = reinterpret_cast<const float4*>(&buf[w4][0][0])[grp];
        if (half == 0 && w4 == 0) {
          tot[i] = part_w;
        } else {
          tot[i].x += part_w.x; tot[i].y += part_w.y;
          tot[i].z += part_w.z; tot[i].w += part_w.w;
        }
      }
    }
    __syncthreads();
  }

  // where group i of [MAXG][kCols] lies in a [g][dh] output, if it does
  auto place = [&](int i, int& gi, int& d) {
    const int grp = threadIdx.x + i * kThreads;
    gi = grp / (kCols / 4);
    d = 4 * (grp - gi * (kCols / 4));
    return grp < kGroups && gi < g && d < dh;
  };
  auto store = [&](float* dst, int d, float4 val) {
    if (vec) {
      *reinterpret_cast<float4*>(dst) = val;
    } else {
      const float e[4] = {val.x, val.y, val.z, val.w};
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (d + c < dh) dst[c] = e[c];
    }
  };
  float* obh = out + (long long)bh * g * dh;
  if (nsplit == 1) {
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      int gi, d;
      if (!place(i, gi, d)) continue;
      const float norm = fmaxf(s_l[gi], 1e-30f);
      store(obh + gi * dh + d, d, make_float4(tot[i].x / norm, tot[i].y / norm,
                                              tot[i].z / norm, tot[i].w / norm));
    }
    return;
  }

  // this split's partial: acc [bh][split][g][dh], then (m, l)
  // [bh][split][g][2] after all the accumulators
  const long long nparts = (long long)gridDim.x * nsplit;
  const long long jstep = (long long)g * dh;
  float* pacc = part + (long long)bh * nsplit * jstep;
  float* pml = part + nparts * jstep + (long long)bh * nsplit * g * 2;
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    int gi, d;
    if (place(i, gi, d)) store(pacc + split * jstep + gi * dh + d, d, tot[i]);
  }
  if (threadIdx.x < g) {
    pml[(split * g + threadIdx.x) * 2] = s_m[threadIdx.x];
    pml[(split * g + threadIdx.x) * 2 + 1] = s_l[threadIdx.x];
  }
  __threadfence();             // the partial is visible before the count
  __syncthreads();
  if (threadIdx.x == 0) {
    const int done = atomicAdd(&counter[bh], 1);
    s_last = done == nsplit - 1;
    __threadfence();
  }
  __syncthreads();
  if (!s_last) return;

  // the last block merges the partials, read past L1: the (m, l) pairs all
  // at once; warp gi takes query row gi's max M and the scales 2^(m_j - M);
  // each thread then sums its groups' accumulators and the normaliser in
  // split order, kBatch splits' loads in flight at a time
  for (int i = threadIdx.x; i < nsplit * g; i += kThreads) {
    s_pm[i / g][i % g] = __ldcg(pml + 2 * i);
    s_pl[i / g][i % g] = __ldcg(pml + 2 * i + 1);
  }
  __syncthreads();
  if (warp < g) {
    float mx = kNegInf;
    for (int j = lane; j < nsplit; j += 32) mx = fmaxf(mx, s_pm[j][warp]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    for (int j = lane; j < nsplit; j += 32) s_pm[j][warp] = exp2f(s_pm[j][warp] - mx);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    int gi, d;
    if (!place(i, gi, d)) continue;
    const float* src = pacc + gi * dh + d;
    float4 total = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float norm = 0.0f;
    for (int j0 = 0; j0 < nsplit; j0 += kBatch) {
      float4 part_j[kBatch];
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        if (j0 + jj >= nsplit) break;
        const float* pj = src + (j0 + jj) * jstep;
        if (vec) {
          part_j[jj] = __ldcg(reinterpret_cast<const float4*>(pj));
        } else {
          part_j[jj] = make_float4(__ldcg(pj), d + 1 < dh ? __ldcg(pj + 1) : 0.0f,
                                   d + 2 < dh ? __ldcg(pj + 2) : 0.0f,
                                   d + 3 < dh ? __ldcg(pj + 3) : 0.0f);
        }
      }
#pragma unroll
      for (int jj = 0; jj < kBatch; ++jj) {
        if (j0 + jj >= nsplit) break;
        const float sj = s_pm[j0 + jj][gi];
        norm += s_pl[j0 + jj][gi] * sj;
        total.x += part_j[jj].x * sj;
        total.y += part_j[jj].y * sj;
        total.z += part_j[jj].z * sj;
        total.w += part_j[jj].w * sj;
      }
    }
    norm = fmaxf(norm, 1e-30f);
    store(obh + gi * dh + d, d, make_float4(total.x / norm, total.y / norm,
                                            total.z / norm, total.w / norm));
  }
  if (threadIdx.x == 0) counter[bh] = 0;       // ready for the next launch
}

template <int Q, int MAXG>
void launch_one(const float* q, const float* k, const float* v,
                const int* pos, float* out, float* part, int* counter, int b,
                int w, int hkv, int g, int dh, int nsplit, long long qpos,
                long long window, bool vec, cudaStream_t stream) {
  const int per = (w + nsplit - 1) / nsplit;
  swa_decode_kernel<Q, MAXG><<<dim3(b * hkv, nsplit), kThreads, 0, stream>>>(
      q, k, v, pos, out, part, counter, w, hkv, g, dh, per, qpos, window, vec);
}

template <int Q>
void launch_q(int maxg, const float* q, const float* k, const float* v,
              const int* pos, float* out, float* part, int* counter, int b,
              int w, int hkv, int g, int dh, int nsplit, long long qpos,
              long long window, bool vec, cudaStream_t stream) {
  switch (maxg) {
    case 1: launch_one<Q, 1>(q, k, v, pos, out, part, counter, b, w, hkv, g, dh, nsplit, qpos, window, vec, stream); break;
    case 2: launch_one<Q, 2>(q, k, v, pos, out, part, counter, b, w, hkv, g, dh, nsplit, qpos, window, vec, stream); break;
    case 4: launch_one<Q, 4>(q, k, v, pos, out, part, counter, b, w, hkv, g, dh, nsplit, qpos, window, vec, stream); break;
    default: launch_one<Q, 8>(q, k, v, pos, out, part, counter, b, w, hkv, g, dh, nsplit, qpos, window, vec, stream); break;
  }
}

int round_up_pow2(int x) { return x <= 1 ? 1 : x <= 2 ? 2 : x <= 4 ? 4 : 8; }

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

// window < 0: no window.  G <= 8, dh <= 256, 1 <= nsplit <= min(64, W).
// With nsplit > 1: part holds B Hkv nsplit G (dh + 2) floats, and counter
// B Hkv ints that are 0 (each merging block leaves its own at 0 again).
extern "C" int repro_swa_decode(const float* q, const float* k,
                                const float* v, const int* pos, float* out,
                                float* part, int* counter, int b, int w,
                                int hkv, int g, int dh, int nsplit,
                                long long qpos, long long window,
                                void* stream) {
  if (b <= 0 || w <= 0 || hkv <= 0 || g <= 0 || g > 8 || dh <= 0 ||
      dh > 256 || nsplit < 1 || nsplit > kMaxSplit || nsplit > w ||
      (nsplit > 1 && (part == nullptr || counter == nullptr)))
    return (int)cudaErrorInvalidValue;
  const int maxg = round_up_pow2(g);
  const bool vec = dh % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
                   aligned16(out) && (nsplit == 1 || aligned16(part));
  cudaStream_t s = (cudaStream_t)stream;
  if (dh <= 128)
    launch_q<1>(maxg, q, k, v, pos, out, part, counter, b, w, hkv, g, dh, nsplit, qpos, window, vec, s);
  else
    launch_q<2>(maxg, q, k, v, pos, out, part, counter, b, w, hkv, g, dh, nsplit, qpos, window, vec, s);
  return (int)cudaGetLastError();
}
