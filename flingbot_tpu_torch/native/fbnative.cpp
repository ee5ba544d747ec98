// fbnative: the native host runtime of flingbot_tpu_torch (a copy of
// flingbot_tpu/native/fbnative.cpp, which the port may not import).
//
// The reference keeps its host-side heavy lifting in C++
// (PyFlex/bindings/*, PyFlex/core/mesh.cpp for OBJ IO).  The port's
// compute path is PyTorch and CUDA, but the host data path stays native:
//
//  * fb_load_cloth      — quad-mesh OBJ parse + spring-class derivation
//                         (the contract of environment/tasks.py:39-102:
//                         stretch = quad sides, shear = quad diagonals,
//                         bend = stretch-neighbor pairs that aren't shear).
//                         The bend derivation is O(V * deg^2) set work —
//                         pathological in Python for large shirts.
//  * fb_covered_area    — reference-exact top-down covered area
//                         (environment/flex_utils.py:358-395) used as the
//                         host-side oracle for the device metric.
//
// Exposed with a plain C ABI for ctypes (no pybind11, no PyTorch headers).
//
// Build (flingbot_tpu_torch/native/__init__.py does it at first use):
//   g++ -O3 -shared -fPIC -std=c++17 fbnative.cpp -o libfbnative.so

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <set>
#include <string>
#include <utility>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ quad-mesh cloth loader
// ---------------------------------------------------------------------------

struct ClothMesh {
  std::vector<double> vertices;     // V * 3
  std::vector<int64_t> triangles;   // 2F * 3
  std::vector<int64_t> stretch;     // S * 2
  std::vector<int64_t> bend;        // B * 2
  std::vector<int64_t> shear;       // H * 2
};

static thread_local std::string g_error;

ClothMesh* fb_load_cloth(const char* path) {
  FILE* f = std::fopen(path, "r");
  if (!f) {
    g_error = std::string("cannot open ") + path;
    return nullptr;
  }
  auto* mesh = new ClothMesh();
  std::vector<std::array<int64_t, 4>> quads;
  char line[4096];
  while (std::fgets(line, sizeof(line), f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      double x = 0, y = 0, z = 0;
      if (std::sscanf(line + 2, "%lf %lf %lf", &x, &y, &z) == 3) {
        mesh->vertices.push_back(x);
        mesh->vertices.push_back(y);
        mesh->vertices.push_back(z);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      // tokens may be "i", "i/j", "i/j/k"
      std::array<int64_t, 4> q{};
      int count = 0;
      char* save = nullptr;
      for (char* tok = strtok_r(line + 2, " \t\r\n", &save);
           tok && count < 5; tok = strtok_r(nullptr, " \t\r\n", &save)) {
        if (count == 4) { count = 5; break; }
        q[count++] = std::strtoll(tok, nullptr, 10) - 1;
      }
      if (count != 4) {
        g_error = "fb_load_cloth requires a quad mesh";
        std::fclose(f);
        delete mesh;
        return nullptr;
      }
      quads.push_back(q);
    }
  }
  std::fclose(f);

  const int64_t V = (int64_t)mesh->vertices.size() / 3;
  auto key = [](int64_t a, int64_t b) {
    if (a > b) std::swap(a, b);
    return std::make_pair(a, b);
  };
  std::set<std::pair<int64_t, int64_t>> stretch, shear, bend;
  for (const auto& q : quads) {
    mesh->triangles.insert(mesh->triangles.end(), {q[0], q[1], q[2]});
    mesh->triangles.insert(mesh->triangles.end(), {q[0], q[2], q[3]});
    stretch.insert(key(q[0], q[1]));
    stretch.insert(key(q[1], q[2]));
    stretch.insert(key(q[2], q[3]));
    stretch.insert(key(q[3], q[0]));
    shear.insert(key(q[0], q[2]));
    shear.insert(key(q[1], q[3]));
  }
  std::vector<std::vector<int64_t>> nbrs(V);
  for (const auto& e : stretch) {
    nbrs[e.first].push_back(e.second);
    nbrs[e.second].push_back(e.first);
  }
  for (int64_t v = 0; v < V; ++v) {
    auto& ns = nbrs[v];
    std::sort(ns.begin(), ns.end());
    for (size_t i = 0; i + 1 < ns.size(); ++i)
      for (size_t j = i + 1; j < ns.size(); ++j) {
        auto e = key(ns[i], ns[j]);
        if (!shear.count(e)) bend.insert(e);
      }
  }
  auto flatten = [](const std::set<std::pair<int64_t, int64_t>>& s,
                    std::vector<int64_t>& out) {
    out.reserve(s.size() * 2);
    for (const auto& e : s) {
      out.push_back(e.first);
      out.push_back(e.second);
    }
  };
  flatten(stretch, mesh->stretch);
  flatten(bend, mesh->bend);
  flatten(shear, mesh->shear);
  return mesh;
}

const char* fb_last_error() { return g_error.c_str(); }

int64_t fb_mesh_counts(ClothMesh* m, int64_t* out5) {
  if (!m) return -1;
  out5[0] = (int64_t)m->vertices.size() / 3;
  out5[1] = (int64_t)m->triangles.size() / 3;
  out5[2] = (int64_t)m->stretch.size() / 2;
  out5[3] = (int64_t)m->bend.size() / 2;
  out5[4] = (int64_t)m->shear.size() / 2;
  return 0;
}

int64_t fb_mesh_fill(ClothMesh* m, double* verts, int64_t* tris,
                     int64_t* stretch, int64_t* bend, int64_t* shear) {
  if (!m) return -1;
  std::memcpy(verts, m->vertices.data(),
              m->vertices.size() * sizeof(double));
  std::memcpy(tris, m->triangles.data(),
              m->triangles.size() * sizeof(int64_t));
  std::memcpy(stretch, m->stretch.data(),
              m->stretch.size() * sizeof(int64_t));
  std::memcpy(bend, m->bend.data(), m->bend.size() * sizeof(int64_t));
  std::memcpy(shear, m->shear.data(), m->shear.size() * sizeof(int64_t));
  return 0;
}

void fb_mesh_free(ClothMesh* m) { delete m; }

// ---------------------------------------------------------------------------
// reference-exact covered area (flex_utils.py:358-395 semantics)
// ---------------------------------------------------------------------------

double fb_covered_area(const float* pos, int64_t n, int64_t stride,
                       double radius) {
  if (n <= 0) return 0.0;
  double min_x = 1e30, max_x = -1e30, min_z = 1e30, max_z = -1e30;
  for (int64_t i = 0; i < n; ++i) {
    double x = pos[i * stride + 0];
    double z = pos[i * stride + 2];
    min_x = std::min(min_x, x);
    max_x = std::max(max_x, x);
    min_z = std::min(min_z, z);
    max_z = std::max(max_z, z);
  }
  double span_x = (max_x - min_x) / 100.0;
  double span_z = (max_z - min_z) / 100.0;
  if (span_x <= 0 || span_z <= 0) return 0.0;
  static thread_local std::vector<uint8_t> grid;
  grid.assign(10000, 0);
  for (int64_t i = 0; i < n; ++i) {
    double ox = pos[i * stride + 0] - min_x;
    double oz = pos[i * stride + 2] - min_z;
    int lo_x = std::max((int)std::lround((ox - radius) / span_x), 0);
    int hi_x = std::min((int)std::lround((ox + radius) / span_x), 100);
    int lo_z = std::max((int)std::lround((oz - radius) / span_z), 0);
    int hi_z = std::min((int)std::lround((oz + radius) / span_z), 100);
    for (int cx = lo_x; cx <= hi_x; ++cx)
      for (int cz = lo_z; cz <= hi_z; ++cz) {
        int idx = cx * 100 + cz;
        if (idx >= 0 && idx < 10000) grid[idx] = 1;
      }
  }
  int64_t covered = 0;
  for (uint8_t g : grid) covered += g;
  return covered * span_x * span_z;
}

}  // extern "C"
