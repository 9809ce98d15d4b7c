// Host-side point-cloud reader: PCD decode (ASCII + binary, uncompressed)
// and the RandomSamplePoints sampling (permute + truncate + zero-pad,
// datasets/data_transforms.py:162-174), the port's copy of
// sparenet_tpu/native/pcloud.cc, code unchanged.
//
// The binary path reads x/y/z only from float fields (F 4, F 8) and gives
// 0.0 for integer-typed ones; the ASCII path reads every type. The port
// keeps that (sparenet_tpu_torch/data/io.py).
//
// C ABI only (consumed via ctypes from sparenet_tpu_torch.native).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <string>
#include <vector>

extern "C" {

// Parse a .pcd file. Returns number of points, or -1 on failure.
// On success *out_xyz is malloc'd [n * 3] float32 (caller frees via
// pcd_free).
int64_t pcd_read(const char* path, float** out_xyz) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;

  char line[4096];
  std::vector<std::string> fields, types;
  std::vector<int> sizes, counts;
  int64_t n_points = -1;
  bool binary = false;
  bool ok = false;

  while (fgets(line, sizeof line, f)) {
    if (line[0] == '#') continue;
    char key[64];
    if (sscanf(line, "%63s", key) != 1) continue;
    std::string k(key);
    const char* rest = line + k.size();
    if (k == "FIELDS" || k == "TYPE") {
      std::vector<std::string>& dst = (k == "FIELDS") ? fields : types;
      dst.clear();
      char buf[64];
      int off = 0, used = 0;
      while (sscanf(rest + off, "%63s%n", buf, &used) == 1) {
        dst.emplace_back(buf);
        off += used;
      }
    } else if (k == "SIZE" || k == "COUNT") {
      std::vector<int>& dst = (k == "SIZE") ? sizes : counts;
      dst.clear();
      int v, off = 0, used = 0;
      while (sscanf(rest + off, "%d%n", &v, &used) == 1) {
        dst.push_back(v);
        off += used;
      }
    } else if (k == "POINTS") {
      sscanf(rest, "%ld", &n_points);
    } else if (k == "DATA") {
      char kind[32];
      if (sscanf(rest, "%31s", kind) == 1) {
        binary = strcmp(kind, "binary") == 0;
        ok = binary || strcmp(kind, "ascii") == 0;
      }
      break;
    }
  }
  if (!ok || n_points < 0 || fields.empty()) {
    fclose(f);
    return -1;
  }
  if (counts.empty()) counts.assign(fields.size(), 1);
  if (sizes.size() != fields.size() || types.size() != fields.size() ||
      counts.size() != fields.size()) {
    fclose(f);
    return -1;
  }

  // locate x/y/z fields and the record stride
  int xi = -1, yi = -1, zi = -1;
  std::vector<int> offsets(fields.size());
  int stride = 0;
  for (size_t i = 0; i < fields.size(); ++i) {
    offsets[i] = stride;
    stride += sizes[i] * counts[i];
    if (fields[i] == "x") xi = (int)i;
    if (fields[i] == "y") yi = (int)i;
    if (fields[i] == "z") zi = (int)i;
  }
  if (xi < 0 || yi < 0 || zi < 0) {
    fclose(f);
    return -1;
  }

  float* xyz = (float*)malloc(sizeof(float) * 3 * (size_t)n_points);
  if (!xyz) {
    fclose(f);
    return -1;
  }

  if (binary) {
    std::vector<unsigned char> rec(stride);
    auto load_f = [&](int fi) -> float {
      const unsigned char* p = rec.data() + offsets[fi];
      if (types[fi] == "F" && sizes[fi] == 4) {
        float v;
        memcpy(&v, p, 4);
        return v;
      }
      if (types[fi] == "F" && sizes[fi] == 8) {
        double v;
        memcpy(&v, p, 8);
        return (float)v;
      }
      return 0.0f;
    };
    for (int64_t i = 0; i < n_points; ++i) {
      if (fread(rec.data(), 1, stride, f) != (size_t)stride) {
        free(xyz);
        fclose(f);
        return -1;
      }
      xyz[i * 3 + 0] = load_f(xi);
      xyz[i * 3 + 1] = load_f(yi);
      xyz[i * 3 + 2] = load_f(zi);
    }
  } else {
    // ascii: one whitespace-separated record per line
    size_t nvals = 0;
    for (size_t i = 0; i < fields.size(); ++i) nvals += counts[i];
    std::vector<double> vals(nvals);
    std::vector<size_t> vidx(fields.size());
    size_t acc = 0;
    for (size_t i = 0; i < fields.size(); ++i) {
      vidx[i] = acc;
      acc += counts[i];
    }
    for (int64_t i = 0; i < n_points; ++i) {
      for (size_t v = 0; v < nvals; ++v) {
        if (fscanf(f, "%lf", &vals[v]) != 1) {
          free(xyz);
          fclose(f);
          return -1;
        }
      }
      xyz[i * 3 + 0] = (float)vals[vidx[xi]];
      xyz[i * 3 + 1] = (float)vals[vidx[yi]];
      xyz[i * 3 + 2] = (float)vals[vidx[zi]];
    }
  }
  fclose(f);
  *out_xyz = xyz;
  return n_points;
}

void pcd_free(float* p) { free(p); }

// RandomSamplePoints (datasets/data_transforms.py:162-174): Fisher-Yates
// permutation sample of n_out rows from xyz [n_in, 3]; zero-pads when
// n_in < n_out. Deterministic per seed.
void sample_points(const float* xyz, int64_t n_in, float* out,
                   int64_t n_out, uint64_t seed) {
  std::mt19937_64 rng(seed);
  std::vector<int64_t> perm(n_in);
  for (int64_t i = 0; i < n_in; ++i) perm[i] = i;
  for (int64_t i = n_in - 1; i > 0; --i) {
    std::uniform_int_distribution<int64_t> d(0, i);
    int64_t j = d(rng);
    std::swap(perm[i], perm[j]);
  }
  int64_t take = n_in < n_out ? n_in : n_out;
  for (int64_t i = 0; i < take; ++i) {
    memcpy(out + i * 3, xyz + perm[i] * 3, 3 * sizeof(float));
  }
  if (take < n_out) {
    memset(out + take * 3, 0, (size_t)(n_out - take) * 3 * sizeof(float));
  }
}

// Fused read + sample: decode path, sample n_out points into out.
// Returns 0 on success, -1 on failure.
int pcd_read_sampled(const char* path, float* out, int64_t n_out,
                     uint64_t seed) {
  float* xyz = nullptr;
  int64_t n = pcd_read(path, &xyz);
  if (n < 0) return -1;
  sample_points(xyz, n, out, n_out, seed);
  free(xyz);
  return 0;
}

}  // extern "C"
