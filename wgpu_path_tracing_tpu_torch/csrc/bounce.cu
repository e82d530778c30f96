// K2: one bounce's shading, one thread per ray, untextured or textured, with
// or without the bounce-0 low-discrepancy override of rng="stratified".
//
// Replaces the TPU kernel wgpu_path_tracing_tpu/ops/pallas_bounce.py::
// _bounce_kernel (entered through bounce_stage_pallas, driven by
// trace_pallas). That kernel shades (1, 1024)-lane blocks and reaches the
// winner's table row through one-hot MXU selects with a 3-term bf16 split,
// because a TPU vector unit has no per-lane gather. Here each thread loads
// its own rows: tri_full[idx * 52 + c] and light_full[l * 27 + c]. None of
// the TPU's select, chunking or column-pruning machinery is needed.
//
// Textures. The TPU kernel samples its atlas three ways: the per-slot
// in-VMEM sampler (_make_atlas_sampler), the in-VMEM fat-canvas sampler
// (_make_fat_sampler), and "external" mode, where XLA gathers the texels
// before the kernel (_gather_texels) because VMEM cannot hold a big atlas.
// All three exist because a TPU has no per-lane gather; here a texel is
// one direct load, so one template parameter covers them, decided by data
// as every JAX path decides it (fat if and only if the scene has a baked
// fat canvas):
//   TEX_NONE  untextured; the instruction stream of the untextured kernel;
//   TEX_SLOT  per used slot, ax = rx + fmodf(u, 1) * rw (and ay), clipped
//             to the atlas, truncated, one 16-byte texel load; a zero-width
//             or zero-height rect takes the slot's fallback;
//   TEX_FAT   the lane's 16 rect values matched against the (S, 20) table
//             (held in shared memory; the last match wins, no match gives
//             the rect (0, 0, 0, 0)), then one 16-byte load per used slot
//             from the lane's 64-byte fat row, each slot masked by its own
//             zero-rect test.
// `slots` is the scene's 4-bit texture_slots_used mask (albedo, pbr,
// emissive, normal); an unused slot takes its fallback without a load.
//
// The LDS override (the TPU kernel's has_lds operand, pallas_bounce.py:413,
// 440-442, 506-511). With rng="stratified" the first bounce's lobe pick and
// direction pair come from the (3, N) rows lds = [lobe, r1, r2]: after the
// three masked rand() calls of sample_bsdf, which advance the state exactly
// as always, their values are replaced. The TPU kernel gates this on
// bounce_ref[0] == 0 inside the kernel and reads the operand at every
// bounce; here the host knows the bounce, so the template flag LDS is set
// for the bounce-0 launch only. The operand is read once a frame (12 B a
// ray), and every other launch, and every launch of rng="reference" and
// "hash", runs the instruction stream without it.
//
// The environment map (template flag ENV). The JAX package lights a miss
// with an equirect map only on its XLA bounce (ops/trace.py:104-108 there,
// sampled by its ops/env.py::make_env_sampler): its Pallas kernel has no map
// and the pipeline turns the kernel off when a scene has one
// (render/pipeline.py:46-59). That term sits in no pallas_call; here it runs
// inside K2, after the emissive term, in the plain version's order
// (ops/env.py): d = normalize(rd), u = (atan2f(d.z, d.x) + rotation) /
// float32(2 pi), u -= floorf(u), v = acosf(clamp(d.y, -1, 1)) *
// float32(1 / pi), the texel (trunc(v h), trunc(u w)) clipped to the map,
// times the intensity, times the throughput, added to the result on every
// lane (zero off the missed lanes: -0 + 0 is +0). Only a missed lane
// computes and reads it: one texel (12 B) of the (H, W, 3) map a missed
// ray. atan2f, acosf and floorf are the CUDA math library's, as PyTorch's
// CUDA torch.atan2, torch.acos and torch.floor call them; the
// ENV = false instantiations are the instruction stream of the kernel
// without a map.
//
// What it computes is ops/trace.py::bounce_core of this package: hit
// attributes (ops/shade.py), emissive termination x 1/(1+t^2), NEE with the
// power heuristic (ops/lights.py, ops/bsdf.py), the BSDF sample, the
// throughput update, and Russian roulette from bounce 3. The PCG state is a
// native uint32_t and advances with an ordinary `if` per draw, in exactly the
// draw order of the plain version.
//
// Bound on the H100: device-memory bytes by the table's count, instruction
// issue in fact. A ray reads 65 B of state (rays, throughput, result, t,
// idx, rng, alive; 12 B more with LDS) and writes 102 B (next rays,
// throughput, result, shadow ray, t_max, mask, direct, pdf, rng, alive);
// the two tables (36 x 52 and a few x 27 floats for the Cornell box) stay
// resident in L1/L2. A textured ray adds at most 16 B a used slot; the
// atlas (16 KB at 32^2, 4 MB at 512^2) and the fat canvas (8 MB for the
// 512^2 congruent atlas) fit the 50 MB L2. Every intermediate stays in
// registers and device memory is touched once per input and output, all
// SoA (rows of N), so neighbouring threads read and write neighbouring
// addresses. What costs time is the arithmetic an exact build issues (IEEE
// divisions, square roots, sines and cosines are instruction sequences), so
// the design issues only what a lane's outputs need:
// - each lane computes the case it selects and no other, where the plain
//   version computes every case and selects: its BSDF lobe (diffuse: the
//   cosine direction; specular: the GGX half-vector and the reflection;
//   transmission: the half-vector, the refraction test, the Fresnel draw
//   and the reflection or refraction), its evaluation branch (reflective or
//   transmissive), its light type (directional, point or spot, emissive),
//   the light's BSDF evaluation only where the NEE contribution is taken,
//   the BSDF sample and its evaluation only on a lane that continues, the
//   normal map's tangent basis only where its texel is applied, and Russian
//   roulette only where it draws. Only selects became branches: a blend,
//   such as pdf_r = diffuse_prob * diffuse_pdf + specular_prob *
//   specular_pdf, keeps every term, since a zero weight times an inf or NaN
//   term is NaN; an addition of a selected zero (result + emission) keeps
//   its addition, since -0 + 0 is +0. A dead or missed lane still shades
//   row 0 and writes its shadow ray from it, as the plain version does;
// - the shading row is read as 16-byte loads (tri_full rows are 52 floats,
//   208 B, 16-byte aligned): 8 float4 untextured (columns 0-19 and 24-35),
//   all 13 textured, in place of about 35 scalar loads;
// - light_full rows (27 floats, not 16-byte aligned) are read a column at a
//   time, only the columns of the lane's light type;
// - each sine and cosine of one angle come from one sincosf, which shares
//   their range reduction and gives sinf's and cosf's bits
//   (chip_smoke.py holds the kernel to torch.sin and torch.cos through the
//   plain version).
//
// Exactness: every branch computes its case in the plain version's
// expression order (left-associated sums, products rounded before sums).
// The library is compiled with -fmad=false and without --use_fast_math, so
// each product, sum, IEEE division, sqrtf, sinf and cosf rounds as
// PyTorch's separate elementwise kernels round it, and the outputs equal
// the plain version's bit for bit, dead lanes included. A draw whose mask
// is false leaves the PCG state as it is, so a branch that skips such a
// draw (the Fresnel draw off the transmission lobe, the emissive light's
// two draws off an emissive light, Russian roulette off its lanes) moves no
// state. Min/max follow PyTorch's NaN rules (clamp and maximum propagate a
// NaN operand).
//
// Where exactness could break on textured lanes, and what keeps it:
// - a NaN texel coordinate. A dead lane (found == false) shades row 0, and
//   its barycentrics can be inf or NaN (a = 0), so ax can be NaN. cvt.rzi
//   gives 0 for NaN, torch.clamp keeps it and PyTorch's CPU integer
//   conversion gives INT_MIN; the plain version (ops/shade.py::texel_index)
//   and texel_index below both map NaN to 0 before clamping, explicitly.
//   Dead lanes' values reach the shadow-ray outputs through the hit's
//   normal and position, so the index must agree there too;
// - fmodf, as torch.fmod (both exact), not u - truncf(u);
// - the tangent basis: r = 1 / (duv1u * duv2v - duv1v * duv2u) has no
//   degenerate guard (JAX shade.py:257), a NaN basis is consumed only where
//   the normal-map texel differs from (0.5, 0.5, 1), and the expression
//   order and the IEEE division are the plain version's;
// - the match table is float32 as on the XLA path; its values are integer
//   pixel coordinates, exact in float32.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

// Constants are written as double literals cast to float: that is how a
// Python float meets a float32 tensor in the plain version.
#define F32(x) (static_cast<float>(x))
constexpr double kPi = 3.14159265359;  // pt.wgsl:3
constexpr double kEps = 1e-6;          // pt.wgsl:4

// models/types.py column maps (TF_* for tri_full, LF_* for light_full);
// tests/test_torch_bounce.py holds these lines to the Python constants.
constexpr int TF_COLS = 52;
constexpr int TF_V0 = 0;
constexpr int TF_V1 = 3;
constexpr int TF_V2 = 6;
constexpr int TF_N0 = 9;
constexpr int TF_N1 = 12;
constexpr int TF_N2 = 15;
constexpr int TF_UV0 = 18;
constexpr int TF_UV1 = 20;
constexpr int TF_UV2 = 22;
constexpr int TF_BASE_COLOR = 25;
constexpr int TF_METALLIC = 28;
constexpr int TF_ROUGHNESS = 29;
constexpr int TF_EMISSION = 30;
constexpr int TF_EMISSIVE_STRENGTH = 33;
constexpr int TF_IOR = 34;
constexpr int TF_TRANSMISSION = 35;
constexpr int TF_ALBEDO_RECT = 36;
constexpr int TF_NORMAL_RECT = 40;
constexpr int TF_PBR_RECT = 44;
constexpr int TF_EMISSIVE_RECT = 48;
constexpr int LF_COLS = 27;
constexpr int LF_POSITION = 0;
constexpr int LF_TYPE = 3;
constexpr int LF_COLOR = 4;
constexpr int LF_INTENSITY = 7;
constexpr int LF_V0 = 9;
constexpr int LF_V1 = 12;
constexpr int LF_V2 = 15;
constexpr int LF_N0 = 18;
constexpr int LF_N1 = 21;
constexpr int LF_N2 = 24;
constexpr int LF_SPOT_DIR = 9;
constexpr int LF_SPOT_SCALE = 12;
constexpr int LF_SPOT_OFFSET = 13;
constexpr int LIGHT_TYPE_EMISSIVE = 0;
constexpr int LIGHT_TYPE_DIRECTIONAL = 1;
constexpr int LIGHT_TYPE_POINT = 2;
constexpr int LIGHT_TYPE_SPOT = 3;

constexpr int FAT_RECT_COLS = 20;  // 16 rect values | fx, fy, lw, lh
enum TexMode { TEX_NONE = 0, TEX_SLOT = 1, TEX_FAT = 2 };

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v3(float x, float y, float z) { return {x, y, z}; }
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 operator-(V3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ float length(V3 a) { return sqrtf(dot(a, a)); }

__device__ __forceinline__ V3 normalize(V3 a) {
  const float inv = 1.0f / length(a);
  return {a.x * inv, a.y * inv, a.z * inv};
}

__device__ __forceinline__ V3 select(bool m, V3 a, V3 b) { return m ? a : b; }

// torch.clamp_min / clamp_max / clamp: a NaN operand comes through.
__device__ __forceinline__ float clamp_min(float v, float lo) { return isnan(v) ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp01(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}
// torch.maximum: the first NaN operand comes through.
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}

// A light_full row's columns c .. c + 2.
__device__ __forceinline__ V3 load3(const float* row, int c) { return {row[c], row[c + 1], row[c + 2]}; }

// A tri_full row as TF_QUADS float4; col(q, c) is its column c (with c a
// constant, a register).
constexpr int TF_QUADS = TF_COLS / 4;
typedef float4 TriRow[TF_QUADS];

__device__ __forceinline__ float col(const TriRow& q, int c) {
  const float4& v = q[c >> 2];
  return (c & 3) == 0 ? v.x : ((c & 3) == 1 ? v.y : ((c & 3) == 2 ? v.z : v.w));
}

__device__ __forceinline__ V3 col3(const TriRow& q, int c) { return {col(q, c), col(q, c + 1), col(q, c + 2)}; }

// The quads of a shading row that MODE reads: untextured, columns 0-19
// (vertices, normals, uv0) and 24-35 (the material); textured, all.
template <int MODE>
__device__ __forceinline__ void load_row(const float* row, TriRow& q) {
  const float4* p = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int k = 0; k < TF_QUADS; ++k) {
    const bool used = MODE != 0 || k < 5 || (k >= 6 && k < 9);
    q[k] = used ? __ldg(p + k) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// random.wgsl's PCG (ops/rng.py). `value` is computed whatever the mask; the
// state moves only where it holds.
__device__ __forceinline__ float rand(uint32_t& state, bool mask) {
  uint32_t s = state * 747796405u + 2891336453u;
  const uint32_t shift = (s >> 28) + 4u;
  uint32_t word = ((s >> shift) ^ s) * 277803737u;
  word = (word >> 22) ^ word;
  if (mask) state = s;
  return static_cast<float>(word) * 0x1p-32f;
}

// ---- BSDF (ops/bsdf.py) ----------------------------------------------------

__device__ __forceinline__ V3 reflect(V3 e, V3 n) { return e - n * (F32(2.0) * dot(e, n)); }

__device__ __forceinline__ V3 refract(V3 e, V3 n, float eta) {
  const float cos_i = dot(n, e);
  const float k = 1.0f - eta * eta * (1.0f - cos_i * cos_i);
  const V3 out = e * eta - n * (eta * cos_i + sqrtf(clamp_min(k, 0.0f)));
  return k < 0.0f ? v3(0.0f, 0.0f, 0.0f) : out;
}

__device__ __forceinline__ void construct_tbn(V3 n, V3& t, V3& b) {
  const bool use_y = fabsf(n.x) > F32(0.9);
  const V3 t0 = v3(use_y ? 0.0f : 1.0f, use_y ? 1.0f : 0.0f, 0.0f);
  b = normalize(cross(n, t0));
  t = normalize(cross(b, n));
}

__device__ __forceinline__ float distribution_ggx(V3 n, V3 h, float roughness) {
  const float a = roughness * roughness;
  const float a2 = a * a;
  const float ndoth = clamp_min(dot(n, h), 0.0f);
  const float denom = ndoth * ndoth * (a2 - 1.0f) + 1.0f;
  return clamp_min(a2 / (F32(kPi) * denom * denom), 0.0f);
}

__device__ __forceinline__ float geometry_schlick_ggx(float ndotv, float roughness) {
  const float r = roughness + 1.0f;
  const float k = (r * r) / 8.0f;
  return ndotv / (ndotv * (1.0f - k) + k);
}

__device__ __forceinline__ float geometry_smith(V3 n, V3 v, V3 l, float roughness) {
  const float ndotv = clamp_min(dot(n, v), 0.0f);
  const float ndotl = clamp_min(dot(n, l), 0.0f);
  return geometry_schlick_ggx(ndotv, roughness) * geometry_schlick_ggx(ndotl, roughness);
}

__device__ __forceinline__ float pow5(float x) {
  const float x2 = x * x;
  return x2 * x2 * x;
}

__device__ __forceinline__ float reflectance(float cos_theta, float eta) {
  float r0 = (1.0f - eta) / (1.0f + eta);
  r0 = r0 * r0;
  return r0 + (1.0f - r0) * pow5(1.0f - cos_theta);
}

// ---- textures (ops/shade.py::sample_atlas, sample_atlas_fat) --------------

struct Tex {
  const float* atlas;  // TEX_SLOT: (h, w, 4) atlas; TEX_FAT: (h, w, 16) canvas
  int h, w;
  const float* rects;  // TEX_FAT: (n_sets, 20) match table
  int n_sets;
  int slots;  // bit k: slot k is mapped somewhere in the scene
};

// ops/shade.py SLOT_RECT_COLS and SLOT_FALLBACKS, slot order (albedo, pbr,
// emissive, normal); fat rows carry 4 channels a slot in the same order.
__device__ __forceinline__ int slot_rect_col(int k) {
  return k == 0 ? TF_ALBEDO_RECT : (k == 1 ? TF_PBR_RECT : (k == 2 ? TF_EMISSIVE_RECT : TF_NORMAL_RECT));
}

__device__ __forceinline__ float4 slot_fallback(int k) {
  return k == 3 ? make_float4(0.5f, 0.5f, 1.0f, 1.0f) : make_float4(1.0f, 1.0f, 1.0f, 1.0f);
}

// ops/shade.py::texel_index: NaN -> 0, clip to [0, size - 1], truncate.
__device__ __forceinline__ int texel_index(float a, int size) {
  const float c = isnan(a) ? 0.0f : fminf(fmaxf(a, 0.0f), static_cast<float>(size - 1));
  return static_cast<int>(c);
}

__device__ __forceinline__ float4 load_texel(const float* base, int64_t offset) {
  return __ldg(reinterpret_cast<const float4*>(base + offset));
}

// The four slot quads of one lane, in slot order; unused slots keep their
// fallbacks (the caller never reads them).
template <int MODE>
__device__ __forceinline__ void sample_slots(const TriRow& q, float uv_u, float uv_v,
                                             const Tex& tex, const float* rects,
                                             float4 (&quad)[4]) {
  const float fu = fmodf(uv_u, 1.0f);
  const float fv = fmodf(uv_v, 1.0f);
  if constexpr (MODE == TEX_SLOT) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      quad[k] = slot_fallback(k);
      if (!((tex.slots >> k) & 1)) continue;
      const int c = slot_rect_col(k);
      const bool missing = (col(q, c + 2) == 0.0f) || (col(q, c + 3) == 0.0f);
      if (missing) continue;
      const float ax = col(q, c) + fu * col(q, c + 2);
      const float ay = col(q, c + 1) + fv * col(q, c + 3);
      const int ix = texel_index(ax, tex.w);
      const int iy = texel_index(ay, tex.h);
      quad[k] = load_texel(tex.atlas, (static_cast<int64_t>(iy) * tex.w + ix) * 4);
    }
  } else if constexpr (MODE == TEX_FAT) {
    float vals[16];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
#pragma unroll
      for (int c = 0; c < 4; ++c) vals[4 * k + c] = col(q, slot_rect_col(k) + c);
    }
    float fx = 0.0f, fy = 0.0f, vw = 0.0f, vh = 0.0f;
    for (int s = 0; s < tex.n_sets; ++s) {
      const float* set = rects + s * FAT_RECT_COLS;
      bool m = true;
#pragma unroll
      for (int j = 0; j < 16; ++j) m = m && (vals[j] == set[j]);
      if (m) {  // the last matching set wins
        fx = set[16];
        fy = set[17];
        vw = set[18];
        vh = set[19];
      }
    }
    const float ax = fx + fu * vw;
    const float ay = fy + fv * vh;
    const int ix = texel_index(ax, tex.w);
    const int iy = texel_index(ay, tex.h);
    const int64_t texel = (static_cast<int64_t>(iy) * tex.w + ix) * 16;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      quad[k] = slot_fallback(k);
      if (!((tex.slots >> k) & 1)) continue;
      const bool missing = (vals[4 * k + 2] == 0.0f) || (vals[4 * k + 3] == 0.0f);
      if (!missing) quad[k] = load_texel(tex.atlas, texel + 4 * k);
    }
  }
}

struct Hit {
  V3 position, normal, albedo, emission;
  float roughness, metallic, transmission, ior, emissive_strength;
  bool is_front;
};

// evalBSDF (pt.wgsl:548-614); returns the pdf, writes the value. The plain
// version computes the reflective and the transmissive result and selects
// on transmission > 0; here a lane computes the one it selects.
__device__ float eval_bsdf(const Hit& hit, V3 normal, V3 v, V3 l, bool front, V3& bsdf) {
  const float m = hit.metallic;
  if (hit.transmission > 0.0f) {
    const float eta = front ? 1.0f / hit.ior : hit.ior;
    const float cos_theta = dot(normal, v);
    const float f_trans = reflectance(fabsf(cos_theta), eta);
    bsdf = hit.albedo * (1.0f - f_trans);
    const float pdf_t = (1.0f - m) * hit.transmission;
    return clamp_min(pdf_t, F32(kEps));
  }
  const V3 h = normalize(v + l);
  const float ndotl = clamp_min(dot(normal, l), 0.0f);
  const float ndotv = clamp_min(dot(normal, v), 0.0f);
  const float ndoth = clamp_min(dot(normal, h), 0.0f);
  const float vdoth = clamp_min(dot(v, h), 0.0f);

  const float base = (1.0f - m) * F32(0.04);
  const V3 f0 = v3(base + hit.albedo.x * m, base + hit.albedo.y * m, base + hit.albedo.z * m);
  const float p = pow5(1.0f - vdoth);
  const V3 f = v3(f0.x + (1.0f - f0.x) * p, f0.y + (1.0f - f0.y) * p, f0.z + (1.0f - f0.z) * p);
  const float g = geometry_smith(normal, v, l, hit.roughness);
  const float d = distribution_ggx(normal, h, hit.roughness);

  // Both terms of each blend stay, whatever their weights: a zero weight
  // times an inf or NaN term is NaN in the plain version too.
  const float kd_scale = 1.0f - hit.transmission;
  const float spec_scale = (g * d) / clamp_min(4.0f * ndotv * ndotl, F32(kEps));
  const V3 diffuse = v3((1.0f - f.x) * kd_scale * hit.albedo.x / F32(kPi),
                        (1.0f - f.y) * kd_scale * hit.albedo.y / F32(kPi),
                        (1.0f - f.z) * kd_scale * hit.albedo.z / F32(kPi));
  const V3 specular = f * spec_scale;
  bsdf = (diffuse + specular) * ndotl;
  const float diffuse_prob = (1.0f - m) * (1.0f - hit.transmission);
  const float specular_prob = m;
  const float diffuse_pdf = ndotl / F32(kPi);
  const float specular_pdf = d * ndoth / (4.0f * vdoth);
  const float pdf_r = diffuse_prob * diffuse_pdf + specular_prob * specular_pdf;
  return clamp_min(pdf_r, F32(kEps));
}

__device__ __forceinline__ V3 cosine_direction(V3 normal, float r1, float r2) {
  const float z = sqrtf(1.0f - r2);
  const float phi = F32(2.0 * kPi) * r1;
  const float sq = sqrtf(r2);
  float sin_phi, cos_phi;
  sincosf(phi, &sin_phi, &cos_phi);
  const float x = cos_phi * sq;
  const float y = sin_phi * sq;
  V3 t, b;
  construct_tbn(normal, t, b);
  return t * x + b * y + normal * z;
}

__device__ __forceinline__ V3 sample_ggx_normal(V3 normal, float roughness, float r1, float r2) {
  const float a = roughness * roughness;
  const float phi = F32(2.0 * kPi) * r1;
  const float cos_t = sqrtf((1.0f - r2) / (1.0f + (a * a - 1.0f) * r2));
  const float sin_t = sqrtf(1.0f - cos_t * cos_t);
  float sin_phi, cos_phi;
  sincosf(phi, &sin_phi, &cos_phi);
  const float lx = sin_t * cos_phi;
  const float ly = sin_t * sin_phi;
  V3 t, b;
  construct_tbn(normal, t, b);
  return normalize(t * lx + b * ly + normal * cos_t);
}

// sampleBSDF (pt.wgsl:498-546): lobe select, two direction draws, and the
// Fresnel draw only on transmission lanes that can refract. With LDS the
// three main draws' values are `ov`'s; the state advances all the same.
// The plain version computes the three lobes' directions and selects; here
// a lane computes its own lobe's. Off the transmission lobe the Fresnel
// draw's mask is false, so skipping it leaves the state where it was.
template <bool LDS>
__device__ V3 sample_bsdf(const Hit& hit, V3 rd, bool front, uint32_t& state, bool mask,
                          const float (&ov)[3]) {
  const float diffuse_prob = (1.0f - hit.metallic) * (1.0f - hit.transmission);
  const float specular_prob = hit.metallic;

  float r = rand(state, mask);
  float r1 = rand(state, mask);
  float r2 = rand(state, mask);
  if constexpr (LDS) {
    r = ov[0];
    r1 = ov[1];
    r2 = ov[2];
  }

  if (r < diffuse_prob) return cosine_direction(hit.normal, r1, r2);

  const V3 v = -normalize(rd);
  const float rough = clamp_min(hit.roughness, F32(0.04));  // pt.wgsl:518
  const V3 h_s = sample_ggx_normal(hit.normal, rough, r1, r2);
  if (r < diffuse_prob + specular_prob) return reflect(-v, h_s);

  const float eta = front ? 1.0f / hit.ior : hit.ior;
  const V3 n_t = select(front, h_s, -h_s);
  const float cos_theta = dot(n_t, v);
  const float sin_theta = sqrtf(clamp_min(1.0f - cos_theta * cos_theta, 0.0f));
  const bool cannot_refract = eta * sin_theta > 1.0f;
  const float f = reflectance(fabsf(cos_theta), eta);
  const float r3 = rand(state, mask && !cannot_refract);
  if (cannot_refract || (r3 < f)) return reflect(-v, n_t);
  return refract(-v, n_t, eta);
}

// ---- NEE (ops/lights.py::sample_light_from_fetch) --------------------------

struct LightSample {
  V3 intensity, wi, shadow_origin;
  float pdf, t_max;
  bool shadow_mask;
};

// The plain version computes the directional, the point (and spot) and the
// emissive sample and selects by the light's type; here a lane computes its
// own light's. A type that is none of the four takes the emissive case, as
// the plain version's selects give it, with the two triangle draws whose
// mask is false.
__device__ LightSample sample_light(const float* __restrict__ lights, V3 hit_position,
                                    uint32_t& state, bool mask, int num_lights) {
  const int count = num_lights > 1 ? num_lights : 1;
  const float value = rand(state, mask);
  int li = static_cast<int>(value * static_cast<float>(count));
  li = li < count - 1 ? li : count - 1;
  const float* row = lights + static_cast<int64_t>(li) * LF_COLS;

  const int ltype = static_cast<int>(row[LF_TYPE]);
  const V3 lcolor = load3(row, LF_COLOR);
  const float lint = row[LF_INTENSITY];
  const float inv_n = 1.0f / static_cast<float>(count);

  V3 wi, intensity;
  float pdf, t_max;
  bool point_far = false;
  if (ltype == LIGHT_TYPE_DIRECTIONAL) {
    wi = normalize(-load3(row, LF_POSITION));
    t_max = CUDART_INF_F;
    pdf = inv_n * 1000.0f;  // pt.wgsl:406
    intensity = lcolor * lint;
  } else if (ltype == LIGHT_TYPE_POINT || ltype == LIGHT_TYPE_SPOT) {
    const V3 to_light = load3(row, LF_POSITION) - hit_position;
    const float dist = length(to_light);
    point_far = dist > 100.0f;
    wi = to_light * (1.0f / clamp_min(dist, F32(1e-30)));
    t_max = dist - F32(kEps * 2.0);
    pdf = inv_n * 10000.0f;  // pt.wgsl:438
    float att = 1.0f / (dist * dist);
    float spot = 1.0f;
    if (ltype == LIGHT_TYPE_SPOT) {
      const V3 spot_dir = load3(row, LF_SPOT_DIR);
      const float cd = dot(spot_dir, -wi);
      const float spot_t = clamp01(cd * row[LF_SPOT_SCALE] + row[LF_SPOT_OFFSET]);
      spot = spot_t * spot_t;
    }
    att = att * spot;
    intensity = lcolor * (lint * att);
  } else {
    const bool is_emis = ltype == LIGHT_TYPE_EMISSIVE;
    const float r1 = rand(state, mask && is_emis);
    const float r2 = rand(state, mask && is_emis);
    const V3 v0 = load3(row, LF_V0), v1 = load3(row, LF_V1), v2 = load3(row, LF_V2);
    const V3 n0 = load3(row, LF_N0), n1 = load3(row, LF_N1), n2 = load3(row, LF_N2);
    const float sq = sqrtf(r1);
    const float su = 1.0f - sq;
    const float sv = r2 * sq;
    const float sw = 1.0f - su - sv;
    const V3 light_pos = v0 * sw + v1 * su + v2 * sv;
    const V3 lnormal = normalize(n0 * sw + n1 * su + n2 * sv);
    const V3 to_light = light_pos - hit_position;
    const float dist = length(to_light);
    wi = to_light * (1.0f / clamp_min(dist, F32(1e-30)));
    t_max = dist - F32(kEps * 2.0);
    const V3 e1 = v1 - v0;
    const V3 e2 = v2 - v0;
    const float area = length(cross(e1, e2)) * F32(0.5);
    const float cos_theta = fabsf(dot(lnormal, -wi));
    // Zero-area rows (the padding row of a lightless scene) give pdf 0.
    const float inv_area = area > 0.0f ? 1.0f / clamp_min(area, F32(1e-30)) : 0.0f;
    pdf = inv_area * inv_n * (dist * dist / clamp_min(cos_theta, F32(kEps)));
    intensity = lcolor * lint;
  }

  const bool dead = point_far || !mask;
  LightSample ls;
  ls.pdf = dead ? 0.0f : pdf;
  ls.intensity = dead ? v3(0.0f, 0.0f, 0.0f) : intensity;
  ls.wi = wi;
  ls.shadow_mask = mask && !point_far;
  ls.shadow_origin = hit_position + wi * F32(kEps);
  ls.t_max = t_max;
  return ls;
}

// ---- the environment map (ops/env.py) --------------------------------------

// float32(2 pi) and float32(1 / pi), as ops/env.py rounds them.
constexpr double kTwoPi32 = 6.283185307179586;
constexpr double kInvPi32 = 0.3183098861837907;

struct Env {
  const float* map;  // (h, w, 3) linear radiance
  int h, w;
  const float* params;  // [intensity, rotation in radians]
};

// torch.clamp(v, -1, 1): a NaN operand comes through.
__device__ __forceinline__ float clamp11(float v) {
  return isnan(v) ? v : fminf(fmaxf(v, -1.0f), 1.0f);
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// ops/env.py::make_env_sampler: the nearest texel of the direction's
// azimuth and polar angle, times the intensity.
__device__ __forceinline__ V3 env_radiance(V3 rd, const Env& env) {
  const V3 d = normalize(rd);
  float u = (atan2f(d.z, d.x) + env.params[1]) / F32(kTwoPi32);
  u = u - floorf(u);
  const float v = acosf(clamp11(d.y)) * F32(kInvPi32);
  const int ix = clampi(static_cast<int>(u * static_cast<float>(env.w)), 0, env.w - 1);
  const int iy = clampi(static_cast<int>(v * static_cast<float>(env.h)), 0, env.h - 1);
  const float* texel = env.map + (static_cast<int64_t>(iy) * env.w + ix) * 3;
  const float intensity = env.params[0];
  return v3(__ldg(texel) * intensity, __ldg(texel + 1) * intensity, __ldg(texel + 2) * intensity);
}

// ---- the bounce (ops/trace.py::bounce_core) ---------------------------------

template <int MODE, bool LDS, bool ENV>
__global__ void bounce_kernel(int bounce_idx, const float* __restrict__ rays,
                              const int64_t* __restrict__ state_in,
                              const float* __restrict__ throughput_in,
                              const float* __restrict__ result_in,
                              const bool* __restrict__ alive_in,
                              const float* __restrict__ t_in,
                              const int* __restrict__ idx_in,
                              const float* __restrict__ tri_full,
                              const float* __restrict__ light_full, int num_lights,
                              int do_mis, Tex tex, const float* __restrict__ lds,
                              Env env, float* __restrict__ rays_out,
                              int64_t* __restrict__ state_out,
                              float* __restrict__ throughput_out,
                              float* __restrict__ result_out, bool* __restrict__ alive_out,
                              float* __restrict__ shadow_rays, float* __restrict__ shadow_t_max,
                              bool* __restrict__ shadow_mask, float* __restrict__ shadow_direct,
                              float* __restrict__ shadow_pdf, int n) {
  extern __shared__ float s_rects[];  // TEX_FAT: the (n_sets, 20) match table
  if constexpr (MODE == TEX_FAT) {
    for (int k = threadIdx.x; k < tex.n_sets * FAT_RECT_COLS; k += blockDim.x) {
      s_rects[k] = tex.rects[k];
    }
    __syncthreads();
  }
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3 ro = v3(rays[i], rays[n + i], rays[2 * n + i]);
  const V3 rd = v3(rays[3 * n + i], rays[4 * n + i], rays[5 * n + i]);
  const V3 thr = v3(throughput_in[i], throughput_in[n + i], throughput_in[2 * n + i]);
  const V3 res_in = v3(result_in[i], result_in[n + i], result_in[2 * n + i]);
  uint32_t state = static_cast<uint32_t>(state_in[i]);
  const float t = t_in[i];
  const int idx = idx_in[i];

  // Hit attributes (ops/shade.py::hit_attributes_from_cols).
  // idx comes from K1 or K3: -1 (miss) or a row of tri_full. A dead or
  // missed lane shades row 0, as the plain version does.
  const bool found = alive_in[i] && (idx >= 0);
  TriRow q;
  load_row<MODE>(tri_full + static_cast<int64_t>(idx > 0 ? idx : 0) * TF_COLS, q);
  Hit hit;
  {
    const V3 n0 = col3(q, TF_N0), n1 = col3(q, TF_N1), n2 = col3(q, TF_N2);
    const V3 v0 = col3(q, TF_V0), v1 = col3(q, TF_V1), v2 = col3(q, TF_V2);
    const V3 e1 = v1 - v0;
    const V3 e2 = v2 - v0;
    const V3 hvec = cross(rd, e2);
    const float a = dot(e1, hvec);
    const float f = 1.0f / a;
    const V3 s = ro - v0;
    const float u = f * dot(s, hvec);
    const V3 qv = cross(s, e1);
    const float v = f * dot(rd, qv);
    const float w = 1.0f - u - v;
    hit.position = ro + rd * t;
    const V3 geom_normal = normalize(cross(e1, e2));
    hit.normal = normalize(n0 * w + n1 * u + n2 * v);
    hit.is_front = dot(geom_normal, rd) < 0.0f;  // pt.wgsl:196-197
    hit.albedo = col3(q, TF_BASE_COLOR);
    hit.roughness = clamp_min(col(q, TF_ROUGHNESS), F32(0.04));  // pt.wgsl:208
    hit.metallic = col(q, TF_METALLIC);
    hit.transmission = col(q, TF_TRANSMISSION);
    hit.ior = col(q, TF_IOR);
    hit.emission = col3(q, TF_EMISSION);
    hit.emissive_strength = col(q, TF_EMISSIVE_STRENGTH);
    if constexpr (MODE != TEX_NONE) {
      const float uv_u = col(q, TF_UV0) * w + col(q, TF_UV1) * u + col(q, TF_UV2) * v;
      const float uv_v = col(q, TF_UV0 + 1) * w + col(q, TF_UV1 + 1) * u + col(q, TF_UV2 + 1) * v;
      float4 quad[4];
      sample_slots<MODE>(q, uv_u, uv_v, tex, s_rects, quad);
      if (tex.slots & 1) {
        hit.albedo = v3(quad[0].x, quad[0].y, quad[0].z) * hit.albedo;
      }
      if (tex.slots & 2) {
        hit.metallic = quad[1].z * col(q, TF_METALLIC);
        hit.roughness = clamp_min(quad[1].y * col(q, TF_ROUGHNESS), F32(0.04));
      }
      if (tex.slots & 4) {
        hit.emission = v3(quad[2].x, quad[2].y, quad[2].z) * hit.emission;
      }
      const float4 nm = quad[3];
      if ((tex.slots & 8) && ((nm.x != 0.5f) || (nm.y != 0.5f) || (nm.z != 1.0f))) {
        // Tangent basis from UV derivatives (pt.wgsl:176-189), no guard,
        // only where the normal map's texel is applied.
        const float duv1u = col(q, TF_UV1) - col(q, TF_UV0);
        const float duv1v = col(q, TF_UV1 + 1) - col(q, TF_UV0 + 1);
        const float duv2u = col(q, TF_UV2) - col(q, TF_UV0);
        const float duv2v = col(q, TF_UV2 + 1) - col(q, TF_UV0 + 1);
        const float r = 1.0f / (duv1u * duv2v - duv1v * duv2u);
        const V3 tangent = normalize((e1 * duv2v - e2 * duv1v) * r);
        const V3 tn = hit.normal;
        const V3 tvec = normalize(tangent - tn * dot(tn, tangent));
        const V3 bvec = normalize(cross(tn, tvec));
        hit.normal = normalize(tvec * (nm.x * 2.0f - 1.0f) + bvec * (nm.y * 2.0f - 1.0f) +
                               tn * (nm.z * 2.0f - 1.0f));
      }
    }
  }

  const V3 zero3 = v3(0.0f, 0.0f, 0.0f);
  const bool emissive =
      found && (hit.emission.x > 0.0f || hit.emission.y > 0.0f || hit.emission.z > 0.0f);
  // The addition stays on every lane: -0 + 0 is +0.
  V3 emitted = zero3;
  if (emissive) {
    const float atten = hit.emissive_strength / (1.0f + t * t);
    emitted = thr * hit.emission * atten;
  }
  V3 result = res_in + emitted;
  if constexpr (ENV) {
    // The miss term (ops/trace.py::bounce_core): a missed lane adds its
    // texel; the addition stays on every lane.
    V3 lit = zero3;
    if (alive_in[i] && (idx < 0)) {
      lit = thr * env_radiance(rd, env);
    }
    result = result + lit;
  }
  const bool cont = found && !emissive;

  V3 s_origin = zero3, s_dir = zero3, s_direct = zero3;
  float s_t_max = CUDART_INF_F, s_pdf = 0.0f;
  bool s_mask = false;
  if (do_mis) {
    const bool nee = cont && (hit.transmission == 0.0f) && hit.is_front;
    const LightSample ls = sample_light(light_full, hit.position, state, nee, num_lights);
    if (nee && (ls.pdf > 0.0f)) {  // the lanes whose contribution is taken
      V3 f_light;
      const float pdf_light_bsdf =
          eval_bsdf(hit, hit.normal, -normalize(rd), ls.wi, hit.is_front, f_light);
      const float f2 = ls.pdf * ls.pdf;
      const float mis_w = f2 / (f2 + pdf_light_bsdf * pdf_light_bsdf);
      const float scale = mis_w / clamp_min(ls.pdf, F32(kEps));
      s_direct = thr * ls.intensity * f_light * scale;
    }
    s_origin = ls.shadow_origin;
    s_dir = ls.wi;
    s_t_max = ls.t_max;
    s_mask = ls.shadow_mask;
    s_pdf = ls.pdf;
  }

  // The BSDF sample and its evaluation on the lanes that continue; every
  // draw of a lane that does not is masked off.
  V3 ro_next = ro, rd_next = rd, throughput = thr;
  bool alive = false;
  if (cont) {
    float ov[3] = {0.0f, 0.0f, 0.0f};
    if constexpr (LDS) {
      ov[0] = lds[i];
      ov[1] = lds[n + i];
      ov[2] = lds[2 * n + i];
    }
    const V3 new_dir = sample_bsdf<LDS>(hit, rd, hit.is_front, state, true, ov);
    V3 f_val;
    const float pdf = eval_bsdf(hit, hit.normal, -normalize(rd), new_dir, hit.is_front, f_val);
    if (pdf > 0.0f) {
      ro_next = hit.position + new_dir * F32(kEps);
      rd_next = normalize(new_dir);
      const float inv_pdf = 1.0f / clamp_min(pdf, F32(kEps));
      throughput = thr * f_val * inv_pdf;
      alive = true;
    }
  }

  // Russian roulette from bounce 3 (pt.wgsl:699-705).
  if (alive && (bounce_idx > 2)) {
    const float u_rr = rand(state, true);
    const float p = maximum(maximum(throughput.x, throughput.y), throughput.z);
    if (u_rr > p) {
      alive = false;
    } else {
      throughput = throughput * (1.0f / p);
    }
  }

  rays_out[i] = ro_next.x;
  rays_out[n + i] = ro_next.y;
  rays_out[2 * n + i] = ro_next.z;
  rays_out[3 * n + i] = rd_next.x;
  rays_out[4 * n + i] = rd_next.y;
  rays_out[5 * n + i] = rd_next.z;
  state_out[i] = static_cast<int64_t>(state);
  throughput_out[i] = throughput.x;
  throughput_out[n + i] = throughput.y;
  throughput_out[2 * n + i] = throughput.z;
  result_out[i] = result.x;
  result_out[n + i] = result.y;
  result_out[2 * n + i] = result.z;
  alive_out[i] = alive;
  shadow_rays[i] = s_origin.x;
  shadow_rays[n + i] = s_origin.y;
  shadow_rays[2 * n + i] = s_origin.z;
  shadow_rays[3 * n + i] = s_dir.x;
  shadow_rays[4 * n + i] = s_dir.y;
  shadow_rays[5 * n + i] = s_dir.z;
  shadow_t_max[i] = s_t_max;
  shadow_mask[i] = s_mask;
  shadow_direct[i] = s_direct.x;
  shadow_direct[n + i] = s_direct.y;
  shadow_direct[2 * n + i] = s_direct.z;
  shadow_pdf[i] = s_pdf;
}

constexpr int kThreads = 128;

}  // namespace

extern "C" int wpt_bounce(int bounce_idx, const void* rays, const void* state,
                          const void* throughput, const void* result, const void* alive,
                          const void* t, const void* idx, const void* tri_full,
                          const void* light_full, int num_lights, int do_mis, int tex_mode,
                          const void* atlas, int atlas_h, int atlas_w, const void* fat_rects,
                          int n_sets, int slots, const void* lds, const void* env_map,
                          int env_h, int env_w, const void* env_params, void* rays_out,
                          void* state_out, void* throughput_out, void* result_out,
                          void* alive_out,
                          void* shadow_rays, void* shadow_t_max, void* shadow_mask,
                          void* shadow_direct, void* shadow_pdf, int n, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  const Tex tex{static_cast<const float*>(atlas), atlas_h, atlas_w,
                static_cast<const float*>(fat_rects), n_sets, slots};
  const Env env{static_cast<const float*>(env_map), env_h, env_w,
                static_cast<const float*>(env_params)};
  auto launch = [&](auto kernel, size_t smem) {
    kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        bounce_idx, static_cast<const float*>(rays), static_cast<const int64_t*>(state),
        static_cast<const float*>(throughput), static_cast<const float*>(result),
        static_cast<const bool*>(alive), static_cast<const float*>(t),
        static_cast<const int*>(idx), static_cast<const float*>(tri_full),
        static_cast<const float*>(light_full), num_lights, do_mis, tex,
        static_cast<const float*>(lds), env, static_cast<float*>(rays_out),
        static_cast<int64_t*>(state_out),
        static_cast<float*>(throughput_out), static_cast<float*>(result_out),
        static_cast<bool*>(alive_out), static_cast<float*>(shadow_rays),
        static_cast<float*>(shadow_t_max), static_cast<bool*>(shadow_mask),
        static_cast<float*>(shadow_direct), static_cast<float*>(shadow_pdf), n);
  };
  const size_t fat_smem = static_cast<size_t>(n_sets) * FAT_RECT_COLS * sizeof(float);
  const bool with_lds = lds != nullptr;
  const bool with_env = env_map != nullptr;
  // The four LDS x ENV instantiations of one texture mode.
  auto pick = [&](auto mode, size_t smem) {
    constexpr int M = decltype(mode)::value;
    if (with_lds) {
      with_env ? launch(bounce_kernel<M, true, true>, smem) : launch(bounce_kernel<M, true, false>, smem);
    } else {
      with_env ? launch(bounce_kernel<M, false, true>, smem) : launch(bounce_kernel<M, false, false>, smem);
    }
  };
  switch (tex_mode) {
    case TEX_NONE:
      pick(std::integral_constant<int, TEX_NONE>{}, 0);
      break;
    case TEX_SLOT:
      pick(std::integral_constant<int, TEX_SLOT>{}, 0);
      break;
    case TEX_FAT:
      pick(std::integral_constant<int, TEX_FAT>{}, fat_smem);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
