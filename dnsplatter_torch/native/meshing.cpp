// Native meshing backend: marching tetrahedra + TSDF integration (the
// port's own copy of dnsplatter_tpu/native/meshing.cpp, built into
// dnsplatter_torch/_build/).
//
// The reference delegates meshing to native code (Open3D ScalableTSDFVolume,
// vdbfusion, PyMCubes — all C++). This module is the host-side meshing
// path; the device TSDF path runs in PyTorch. Exposed through ctypes (no
// pybind dependency).
//
// Build: g++ -O3 -shared -fPIC meshing.cpp -o libmeshing.so

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

// 6-tetrahedra decomposition of a cube; corner offsets; tet edges —
// identical tables to mesh/marching.py.
const int TETS[6][4] = {{0, 5, 1, 6}, {0, 1, 2, 6}, {0, 2, 3, 6},
                        {0, 3, 7, 6}, {0, 7, 4, 6}, {0, 4, 5, 6}};
const int CORNERS[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                           {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
const int TET_EDGES[6][2] = {{0, 1}, {0, 2}, {0, 3}, {1, 2}, {1, 3}, {2, 3}};

// Per 4-bit sign case: up to 2 triangles of tet-edge ids (-1 = none).
int TET_TRIS[16][2][3];
bool tables_init = false;

void init_tables() {
  if (tables_init) return;
  for (int i = 0; i < 16; i++)
    for (int j = 0; j < 2; j++)
      for (int k = 0; k < 3; k++) TET_TRIS[i][j][k] = -1;
  auto set1 = [](int c, int a, int b, int d) {
    TET_TRIS[c][0][0] = a; TET_TRIS[c][0][1] = b; TET_TRIS[c][0][2] = d;
  };
  auto set2 = [](int c, int a0, int b0, int d0, int a1, int b1, int d1) {
    TET_TRIS[c][0][0] = a0; TET_TRIS[c][0][1] = b0; TET_TRIS[c][0][2] = d0;
    TET_TRIS[c][1][0] = a1; TET_TRIS[c][1][1] = b1; TET_TRIS[c][1][2] = d1;
  };
  set1(0b0001, 0, 2, 1);
  set1(0b1110, 0, 1, 2);
  set1(0b0010, 0, 3, 4);
  set1(0b1101, 0, 4, 3);
  set1(0b0100, 1, 5, 3);
  set1(0b1011, 1, 3, 5);
  set1(0b1000, 2, 4, 5);
  set1(0b0111, 2, 5, 4);
  set2(0b0011, 1, 3, 2, 2, 3, 4);
  set2(0b1100, 1, 2, 3, 2, 4, 3);
  set2(0b0101, 0, 2, 5, 0, 5, 3);
  set2(0b1010, 0, 5, 2, 0, 3, 5);
  set2(0b0110, 0, 1, 5, 0, 5, 4);
  set2(0b1001, 0, 5, 1, 0, 4, 5);
  tables_init = true;
}

struct MeshBuf {
  std::vector<float> verts;
  std::vector<int32_t> faces;
};

}  // namespace

extern "C" {

// Returns an opaque handle; query sizes then copy out and free.
void* mt_run(const float* field, int nx, int ny, int nz, float level) {
  init_tables();
  auto* mesh = new MeshBuf();
  std::unordered_map<int64_t, int32_t> edge_to_vertex;
  edge_to_vertex.reserve(1 << 16);
  const int64_t nvox = (int64_t)nx * ny * nz;

  auto fidx = [&](int x, int y, int z) -> int64_t {
    return ((int64_t)x * ny + y) * nz + z;
  };

  float cvals[8];
  int64_t cids[8];
  for (int x = 0; x < nx - 1; x++) {
    for (int y = 0; y < ny - 1; y++) {
      for (int z = 0; z < nz - 1; z++) {
        bool any_in = false, any_out = false;
        for (int c = 0; c < 8; c++) {
          int cx = x + CORNERS[c][0], cy = y + CORNERS[c][1],
              cz = z + CORNERS[c][2];
          cids[c] = fidx(cx, cy, cz);
          cvals[c] = field[cids[c]] - level;
          (cvals[c] < 0 ? any_in : any_out) = true;
        }
        if (!any_in || !any_out) continue;
        for (int t = 0; t < 6; t++) {
          int tcase = 0;
          for (int v = 0; v < 4; v++)
            if (cvals[TETS[t][v]] < 0) tcase |= 1 << v;
          for (int tri = 0; tri < 2; tri++) {
            if (TET_TRIS[tcase][tri][0] < 0) break;
            int32_t vid[3];
            for (int e = 0; e < 3; e++) {
              int te = TET_TRIS[tcase][tri][e];
              int ca = TETS[t][TET_EDGES[te][0]];
              int cb = TETS[t][TET_EDGES[te][1]];
              int64_t ia = cids[ca], ib = cids[cb];
              int64_t lo = ia < ib ? ia : ib, hi = ia < ib ? ib : ia;
              int64_t key = lo * nvox + hi;
              auto it = edge_to_vertex.find(key);
              if (it != edge_to_vertex.end()) {
                vid[e] = it->second;
              } else {
                float fa = cvals[ca], fb = cvals[cb];
                float denom = fa - fb;
                float tt = std::fabs(denom) < 1e-12f ? 0.5f : fa / denom;
                tt = tt < 0.f ? 0.f : (tt > 1.f ? 1.f : tt);
                float pa[3] = {(float)(x + CORNERS[ca][0]),
                               (float)(y + CORNERS[ca][1]),
                               (float)(z + CORNERS[ca][2])};
                float pb[3] = {(float)(x + CORNERS[cb][0]),
                               (float)(y + CORNERS[cb][1]),
                               (float)(z + CORNERS[cb][2])};
                int32_t nv = (int32_t)(mesh->verts.size() / 3);
                for (int d = 0; d < 3; d++)
                  mesh->verts.push_back(pa[d] + tt * (pb[d] - pa[d]));
                edge_to_vertex.emplace(key, nv);
                vid[e] = nv;
              }
            }
            if (vid[0] == vid[1] || vid[1] == vid[2] || vid[0] == vid[2])
              continue;
            // flipped winding (normals out of the negative region),
            // matching the Python implementation
            mesh->faces.push_back(vid[0]);
            mesh->faces.push_back(vid[2]);
            mesh->faces.push_back(vid[1]);
          }
        }
      }
    }
  }
  return mesh;
}

int64_t mt_num_verts(void* h) { return ((MeshBuf*)h)->verts.size() / 3; }
int64_t mt_num_faces(void* h) { return ((MeshBuf*)h)->faces.size() / 3; }

void mt_copy(void* h, float* verts_out, int32_t* faces_out) {
  auto* m = (MeshBuf*)h;
  std::memcpy(verts_out, m->verts.data(), m->verts.size() * sizeof(float));
  std::memcpy(faces_out, m->faces.data(), m->faces.size() * sizeof(int32_t));
}

void mt_free(void* h) { delete (MeshBuf*)h; }
}  // extern "C"
