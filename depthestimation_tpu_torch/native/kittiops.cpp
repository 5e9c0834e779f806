// Host-side data-path kernels (OpenMP), C ABI for ctypes.
//
// Native equivalent of the reference's pybind `utils_lib`
// (external/utils_lib/python/utils_lib.cpp): velodyne -> depth projection
// with occlusion filtering, and hole-filling depth upsampling; plus the
// row-filter reversal of PNG decoding (data/image.py). Used by the KITTI
// and ILIM loaders' hot path; the numpy backend in data/velodyne.py
// implements identical semantics and serves as the oracle in tests.
//
// Build: native/kittiops.py (g++ -O3 -march=native -fopenmp -shared -fPIC,
// at first use, into the checkout's build/native/).

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// velodata: [n, 4] row-major; intr: [3, 4]; m: [4, 4]; out: [height*width]
void generate_depth(const float* velodata, int64_t n, const float* intr,
                    const float* m, int width, int height, int filtering,
                    float filterdiff, float* out) {
  std::vector<float> dmap((size_t)width * height, 0.f);

  // transform + cull + project + z-buffer (sequential: z-buffer races)
  for (int64_t i = 0; i < n; i++) {
    const float* p = velodata + 4 * i;
    float x = m[0] * p[0] + m[1] * p[1] + m[2] * p[2] + m[3] * p[3];
    float y = m[4] * p[0] + m[5] * p[1] + m[6] * p[2] + m[7] * p[3];
    float z = m[8] * p[0] + m[9] * p[1] + m[10] * p[2] + m[11] * p[3];
    if (z < 0.1f) continue;
    float pu = intr[0] * x + intr[1] * y + intr[2] * z + intr[3];
    float pv = intr[4] * x + intr[5] * y + intr[6] * z + intr[7];
    float pw = intr[8] * x + intr[9] * y + intr[10] * z + intr[11];
    int u = (int)(pu / pw - 0.5f);
    int v = (int)(pv / pw - 0.5f);
    if (u < 0 || u >= width || v < 0 || v >= height) continue;
    float& cur = dmap[(size_t)v * width + u];
    if (cur == 0.f || z < cur) cur = z;
  }

  // neighborhood occlusion filter
  std::memset(out, 0, sizeof(float) * (size_t)width * height);
  int o = filtering;
  if (o <= 0) {
    std::memcpy(out, dmap.data(), sizeof(float) * (size_t)width * height);
    return;
  }
#pragma omp parallel for schedule(static)
  for (int v = o; v < height - o - 1; v++) {
    for (int u = o; u < width - o - 1; u++) {
      float z = dmap[(size_t)v * width + u];
      bool bad = false;
      for (int vv = v - o; vv <= v + o && !bad; vv++) {
        for (int uu = u - o; uu <= u + o; uu++) {
          if (vv == v && uu == u) continue;
          float zn = dmap[(size_t)vv * width + uu];
          if (zn == 0.f) continue;
          if ((zn - z) < -filterdiff) { bad = true; break; }
        }
      }
      if (!bad) out[(size_t)v * width + u] = z;
    }
  }
}

// depth: [height, width]; out: same
void upsample_depth(const float* depth, int height, int width, int filtering,
                    float maxdiff, float* out) {
  std::memset(out, 0, sizeof(float) * (size_t)width * height);
  int o = filtering;
#pragma omp parallel for schedule(static)
  for (int v = o; v < height - o - 1; v++) {
    for (int u = o; u < width - o - 1; u++) {
      float z = depth[(size_t)v * width + u];
      if (z != 0.f) { out[(size_t)v * width + u] = z; continue; }
      float max_z = 0.f, min_z = 1e8f, sum_z = 0.f;
      int count = 0;
      for (int vv = v - o; vv <= v + o; vv++) {
        for (int uu = u - o; uu <= u + o; uu++) {
          if (vv == v && uu == u) continue;
          float zn = depth[(size_t)vv * width + uu];
          if (zn == 0.f) continue;
          count++; sum_z += zn;
          if (zn > max_z) max_z = zn;
          if (zn < min_z) min_z = zn;
        }
      }
      if (count == 0) continue;
      if (std::fabs(max_z - min_z) < maxdiff)
        out[(size_t)v * width + u] = sum_z / count;
    }
  }
}

// Polar-grid lidar densification (reference utils_lib.cpp:97-161).
// pts: [n, stride] camera-frame points (x, y, z, ...); out: [vb2*hb2, 4]
// homogeneous points where vb2 = total_vbeams*scale, hb2 = total_hbeams*scale
// (computed by the caller). All float math mirrors the f32 numpy backend
// (data/velodyne.py:upsample_velodyne) so the two are golden-parity.
void upsample_velodyne(const float* pts, int64_t n, int64_t stride,
                       float scale, int total_vbeams, int total_hbeams,
                       float vbeam_fov, float hbeam_fov, float* out) {
  const float kDeg = 57.29577951308232f;  // 180/pi
  const float phioffset = 10.0f;
  const int vbeams = total_vbeams, hbeams = total_hbeams;

  std::vector<float> rmap((size_t)vbeams * hbeams, 0.f);
  std::vector<uint8_t> hit((size_t)vbeams * hbeams, 0);
  for (int64_t i = 0; i < n; i++) {
    const float* p = pts + stride * i;
    float x = p[0], y = p[1], z = p[2];
    float r = std::sqrt(x * x + y * y + z * z);
    float theta = std::atan(x / z) * kDeg;
    float phi = std::asin(y / std::max(r, 1e-9f)) * kDeg - phioffset;
    // numpy .astype(int64) truncates toward zero
    int64_t tb = (int64_t)((theta / hbeam_fov) + hbeams / 2.0f - 0.5f);
    int64_t pb = (int64_t)((phi / vbeam_fov) + vbeams / 2.0f - 0.5f);
    if (tb < 0 || tb >= hbeams || pb < 0 || pb >= vbeams) continue;
    size_t bin = (size_t)pb * hbeams + tb;
    if (!hit[bin] || r < rmap[bin]) { rmap[bin] = r; hit[bin] = 1; }
  }

  const int vb2 = (int)(total_vbeams * scale);
  const int hb2 = (int)(total_hbeams * scale);
  // the numpy regeneration grid is f64: (bins - n/2)*fov/scale in double
  const double vf2 = (double)vbeam_fov / (double)scale;
  const double hf2 = (double)hbeam_fov / (double)scale;
#pragma omp parallel for schedule(static)
  for (int pi = 0; pi < vb2; pi++) {
    int64_t vi = (int64_t)(pi / scale);
    if (vi > vbeams - 1) vi = vbeams - 1;
    // trig matches numpy's f64 radians->f32 cast ordering: the numpy path
    // computes phi2/theta2 in f64 (np.radians of f64 bin grid) then
    // multiplies by f32 r — reproduce with double here
    double phi2 = ((double)pi - vb2 / 2.0) * vf2 + (double)phioffset;
    phi2 *= 0.017453292519943295;  // pi/180
    double cphi = std::cos(phi2), sphi = std::sin(phi2);
    for (int ti = 0; ti < hb2; ti++) {
      int64_t hi = (int64_t)(ti / scale);
      if (hi > hbeams - 1) hi = hbeams - 1;
      double theta2 = ((double)ti - hb2 / 2.0) * hf2;
      theta2 *= 0.017453292519943295;
      float r = rmap[(size_t)vi * hbeams + hi];
      float* o = out + 4 * ((size_t)pi * hb2 + ti);
      o[0] = (float)((double)r * cphi * std::sin(theta2));
      o[1] = (float)((double)r * sphi);
      o[2] = (float)((double)r * cphi * std::cos(theta2));
      o[3] = 1.0f;
    }
  }
}

// Gather 128-plane sweep features at projected RGB pixels
// (reference utils_lib.cpp:20-50). proj_points: [n, 3] (u, v, z);
// sweep_int/sweep_z: [planes, lc_h*lc_w]; nir_img: [lc_h*lc_w].
// Outputs: feat_int/feat_z [planes, n], mask [n], nir_out [n].
void lc_generate(const float* proj_points, int64_t n, const float* sweep_int,
                 const float* sweep_z, int planes, int lc_width, int lc_height,
                 const float* nir_img, float* feat_int, float* feat_z,
                 float* mask, float* nir_out) {
  const int64_t hw = (int64_t)lc_width * lc_height;
  std::memset(feat_int, 0, sizeof(float) * (size_t)planes * n);
  std::memset(feat_z, 0, sizeof(float) * (size_t)planes * n);
  std::memset(mask, 0, sizeof(float) * (size_t)n);
  std::memset(nir_out, 0, sizeof(float) * (size_t)n);
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; i++) {
    const float* p = proj_points + 3 * i;
    // numpy (u + 0.5).astype(int64): truncation toward zero
    int64_t u = (int64_t)(p[0] + 0.5f);
    int64_t v = (int64_t)(p[1] + 0.5f);
    float z = p[2];
    bool inside = u >= 0 && v >= 0 && u < lc_width && v < lc_height &&
                  z != 0.f;
    if (!inside) continue;
    int64_t idx = v * lc_width + u;
    nir_out[i] = nir_img[idx];
    if (z > 18.f || std::isnan(sweep_z[idx])) continue;  // plane 0 nan check
    for (int pl = 0; pl < planes; pl++) {
      feat_int[(size_t)pl * n + i] = sweep_int[(size_t)pl * hw + idx];
      feat_z[(size_t)pl * n + i] = sweep_z[(size_t)pl * hw + idx];
    }
    mask[i] = 1.0f;
  }
}

// Undo the five PNG row filters (None, Sub, Up, Average, Paeth; PNG spec
// section 9) of an inflated, non-interlaced image. raw: h rows of one filter
// byte and `stride` bytes; out: h * stride bytes; bpp: bytes per pixel.
// Sub, Average and Paeth read the reconstructed byte `bpp` to the left, so
// each row runs serially. Returns 0, or 1 + the row whose filter byte is
// not 0..4.
int png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int bpp,
                 uint8_t* out) {
  for (int64_t y = 0; y < h; y++) {
    const uint8_t* in = raw + y * (stride + 1);
    const uint8_t ft = in[0];
    in++;
    uint8_t* cur = out + y * stride;
    const uint8_t* up = y ? cur - stride : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(cur, in, (size_t)stride);
        break;
      case 1:
        for (int64_t x = 0; x < stride; x++)
          cur[x] = (uint8_t)(in[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; x++)
          cur[x] = (uint8_t)(in[x] + (up ? up[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          cur[x] = (uint8_t)(in[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; x++) {
          int a = x >= bpp ? cur[x - bpp] : 0;
          int b = up ? up[x] : 0;
          int c = (up && x >= bpp) ? up[x - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = (uint8_t)(in[x] + pred);
        }
        break;
      default:
        return (int)(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
