// Quadric error metric (QEM) edge-collapse mesh decimation.
//
// Native replacement for the reference's OpenMesh PolyMeshDecimater +
// ModQuadric path (hive/pipeline.py:696-738): simplify a triangle mesh to a
// target face count, bounded by a maximum quadric error per collapse.
//
// Algorithm: Garland & Heckbert '97. Vertex quadrics accumulate the squared
// distance to incident face planes; edges collapse greedily by minimum cost
// (lazy-deletion binary heap with version stamps); optimal collapse position
// solves the 4x4 quadric system, falling back to midpoint/endpoints; collapses
// that would flip a surviving face normal are rejected.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <unordered_map>
#include <unordered_set>
#include <vector>
#include <cstdio>

namespace {

struct Quadric {
  // Symmetric 4x4 quadric, upper triangle: a2 ab ac ad b2 bc bd c2 cd d2
  double q[10] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

  void add_plane(double a, double b, double c, double d, double w = 1.0) {
    q[0] += w * a * a; q[1] += w * a * b; q[2] += w * a * c; q[3] += w * a * d;
    q[4] += w * b * b; q[5] += w * b * c; q[6] += w * b * d;
    q[7] += w * c * c; q[8] += w * c * d;
    q[9] += w * d * d;
  }

  void add(const Quadric& other) {
    for (int i = 0; i < 10; ++i) q[i] += other.q[i];
  }

  double evaluate(const double* v) const {
    const double x = v[0], y = v[1], z = v[2];
    return q[0] * x * x + 2 * q[1] * x * y + 2 * q[2] * x * z + 2 * q[3] * x
         + q[4] * y * y + 2 * q[5] * y * z + 2 * q[6] * y
         + q[7] * z * z + 2 * q[8] * z
         + q[9];
  }

  // Solve for the minimising position; returns false if near-singular.
  bool optimal_position(double* out) const {
    const double a11 = q[0], a12 = q[1], a13 = q[2], b1 = -q[3];
    const double a22 = q[4], a23 = q[5], b2 = -q[6];
    const double a33 = q[7], b3 = -q[8];

    const double det = a11 * (a22 * a33 - a23 * a23)
                     - a12 * (a12 * a33 - a23 * a13)
                     + a13 * (a12 * a23 - a22 * a13);

    // Scale-relative singularity test: quadric entries scale with accumulated
    // plane count, so an absolute epsilon misclassifies very fine or very
    // coarse meshes (flat regions are mathematically singular at any scale).
    const double scale = a11 + a22 + a33;
    if (std::fabs(det) <= 1e-12 * scale * scale * scale) return false;

    const double inv = 1.0 / det;
    out[0] = inv * (b1 * (a22 * a33 - a23 * a23) - a12 * (b2 * a33 - a23 * b3)
                    + a13 * (b2 * a23 - a22 * b3));
    out[1] = inv * (a11 * (b2 * a33 - a23 * b3) - b1 * (a12 * a33 - a23 * a13)
                    + a13 * (a12 * b3 - b2 * a13));
    out[2] = inv * (a11 * (a22 * b3 - b2 * a23) - a12 * (a12 * b3 - b2 * a13)
                    + b1 * (a12 * a23 - a22 * a13));
    return true;
  }
};

struct Candidate {
  double cost;
  int v0, v1;
  uint32_t stamp0, stamp1;
  double pos[3];

  bool operator>(const Candidate& other) const { return cost > other.cost; }
};

struct EdgeKey {
  int64_t key;
  EdgeKey(int a, int b) {
    if (a > b) std::swap(a, b);
    key = (static_cast<int64_t>(a) << 32) | static_cast<uint32_t>(b);
  }
  bool operator==(const EdgeKey& o) const { return key == o.key; }
};

struct EdgeKeyHash {
  size_t operator()(const EdgeKey& e) const {
    return std::hash<int64_t>()(e.key);
  }
};

class Decimator {
 public:
  Decimator(const double* verts, int n_verts, const int* faces, int n_faces)
      : positions_(verts, verts + static_cast<size_t>(n_verts) * 3),
        stamps_(n_verts, 0),
        quadrics_(n_verts),
        vertex_faces_(n_verts),
        alive_vertex_(n_verts, true) {
    faces_.resize(static_cast<size_t>(n_faces) * 3);
    std::memcpy(faces_.data(), faces, faces_.size() * sizeof(int));
    alive_face_.assign(n_faces, true);
    live_faces_ = n_faces;

    for (int f = 0; f < n_faces; ++f) {
      for (int k = 0; k < 3; ++k) vertex_faces_[faces_[f * 3 + k]].push_back(f);
      accumulate_face_quadric(f);
    }

    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    for (int v = 0; v < n_verts; ++v) {
      for (int k = 0; k < 3; ++k) {
        lo[k] = std::min(lo[k], positions_[static_cast<size_t>(v) * 3 + k]);
        hi[k] = std::max(hi[k], positions_[static_cast<size_t>(v) * 3 + k]);
      }
    }
    const double dx = hi[0] - lo[0], dy = hi[1] - lo[1], dz = hi[2] - lo[2];
    scale_sq_ = dx * dx + dy * dy + dz * dz;

    add_boundary_constraints();
  }

  // Open-boundary preservation (Garland & Heckbert §6 / OpenMesh's boundary
  // handling): a plain QEM on an open mesh lets boundary vertices collapse
  // freely inward — a flat disc decimated to 1K faces SHRANK to under half
  // its extent. For every edge used by exactly one face, add a heavily
  // weighted constraint plane through the edge, perpendicular to the face,
  // to both endpoints.
  void add_boundary_constraints() {
    std::unordered_map<int64_t, std::pair<int, int>> edge_count;
    edge_count.reserve(alive_face_.size() * 2);

    for (size_t f = 0; f < alive_face_.size(); ++f) {
      for (int k = 0; k < 3; ++k) {
        const EdgeKey e(faces_[f * 3 + k], faces_[f * 3 + (k + 1) % 3]);
        auto it = edge_count.find(e.key);
        if (it == edge_count.end()) {
          edge_count.emplace(e.key, std::make_pair(1, static_cast<int>(f)));
        } else {
          ++it->second.first;
        }
      }
    }

    constexpr double kBoundaryWeight = 1000.0;

    for (const auto& entry : edge_count) {
      if (entry.second.first != 1) continue;

      const int a = static_cast<int>(entry.first >> 32);
      const int b = static_cast<int>(entry.first & 0xFFFFFFFF);
      const int f = entry.second.second;

      const double* pa = &positions_[static_cast<size_t>(a) * 3];
      const double* pb = &positions_[static_cast<size_t>(b) * 3];
      const int* tri = &faces_[static_cast<size_t>(f) * 3];
      const double* p0 = &positions_[static_cast<size_t>(tri[0]) * 3];
      const double* p1 = &positions_[static_cast<size_t>(tri[1]) * 3];
      const double* p2 = &positions_[static_cast<size_t>(tri[2]) * 3];

      double fe1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
      double fe2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
      double fn[3] = {fe1[1] * fe2[2] - fe1[2] * fe2[1],
                      fe1[2] * fe2[0] - fe1[0] * fe2[2],
                      fe1[0] * fe2[1] - fe1[1] * fe2[0]};

      const double edge[3] = {pb[0] - pa[0], pb[1] - pa[1], pb[2] - pa[2]};
      // Constraint normal: edge x face-normal (perpendicular to the face,
      // containing the edge).
      double n[3] = {edge[1] * fn[2] - edge[2] * fn[1],
                     edge[2] * fn[0] - edge[0] * fn[2],
                     edge[0] * fn[1] - edge[1] * fn[0]};
      const double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
      if (len < 1e-15) continue;
      for (double& c : n) c /= len;

      const double d = -(n[0] * pa[0] + n[1] * pa[1] + n[2] * pa[2]);
      quadrics_[a].add_plane(n[0], n[1], n[2], d, kBoundaryWeight);
      quadrics_[b].add_plane(n[0], n[1], n[2], d, kBoundaryWeight);
    }
  }

  void run(int target_faces, double max_error) {
    max_error_ = max_error;
    seed_candidates();

    long pops = 0, stale = 0, fail = 0, ok = 0;
    while (live_faces_ > target_faces && !heap_.empty()) {
      Candidate top = heap_.top();
      heap_.pop();
      ++pops;

      if (!is_current(top)) { ++stale; continue; }
      if (max_error > 0 && top.cost > max_error) break;
      if (!try_collapse(top, max_error)) { ++fail; continue; }
      ++ok;
    }
    if (getenv("HIVE_QEM_STATS"))
      fprintf(stderr, "qem: pops=%ld stale=%ld fail=%ld ok=%ld heap_left=%zu\n",
              pops, stale, fail, ok, heap_.size());
  }

  void extract(double* out_verts, int* out_n_verts, int* out_faces, int* out_n_faces) {
    const int n = static_cast<int>(positions_.size() / 3);
    std::vector<int> remap(n, -1);
    int next = 0;

    for (size_t f = 0; f < alive_face_.size(); ++f) {
      if (!alive_face_[f]) continue;
      for (int k = 0; k < 3; ++k) {
        const int v = faces_[f * 3 + k];
        if (remap[v] < 0) {
          remap[v] = next;
          std::memcpy(out_verts + static_cast<size_t>(next) * 3,
                      positions_.data() + static_cast<size_t>(v) * 3,
                      3 * sizeof(double));
          ++next;
        }
      }
    }

    int nf = 0;
    for (size_t f = 0; f < alive_face_.size(); ++f) {
      if (!alive_face_[f]) continue;
      for (int k = 0; k < 3; ++k) out_faces[nf * 3 + k] = remap[faces_[f * 3 + k]];
      ++nf;
    }

    *out_n_verts = next;
    *out_n_faces = nf;
  }

 private:
  void accumulate_face_quadric(int f) {
    const int* tri = &faces_[f * 3];
    const double* p0 = &positions_[static_cast<size_t>(tri[0]) * 3];
    const double* p1 = &positions_[static_cast<size_t>(tri[1]) * 3];
    const double* p2 = &positions_[static_cast<size_t>(tri[2]) * 3];

    double e1[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    double e2[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    double n[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                   e1[2] * e2[0] - e1[0] * e2[2],
                   e1[0] * e2[1] - e1[1] * e2[0]};
    const double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len < 1e-15) return;

    for (double& c : n) c /= len;
    const double d = -(n[0] * p0[0] + n[1] * p0[1] + n[2] * p0[2]);

    for (int k = 0; k < 3; ++k)
      quadrics_[tri[k]].add_plane(n[0], n[1], n[2], d);
  }

  void seed_candidates() {
    std::unordered_set<EdgeKey, EdgeKeyHash> seen;
    seen.reserve(alive_face_.size() * 2);

    for (size_t f = 0; f < alive_face_.size(); ++f) {
      for (int k = 0; k < 3; ++k) {
        const int a = faces_[f * 3 + k];
        const int b = faces_[f * 3 + (k + 1) % 3];
        if (seen.insert(EdgeKey(a, b)).second) push_candidate(a, b);
      }
    }
  }

  void push_candidate(int v0, int v1) {
    Quadric combined = quadrics_[v0];
    combined.add(quadrics_[v1]);

    Candidate cand;
    cand.v0 = v0;
    cand.v1 = v1;
    cand.stamp0 = stamps_[v0];
    cand.stamp1 = stamps_[v1];

    const double* p0 = &positions_[static_cast<size_t>(v0) * 3];
    const double* p1 = &positions_[static_cast<size_t>(v1) * 3];

    double best[3];
    if (!combined.optimal_position(best)) {
      // Pick the cheapest of the two endpoints and the midpoint.
      const double mid[3] = {(p0[0] + p1[0]) / 2, (p0[1] + p1[1]) / 2, (p0[2] + p1[2]) / 2};
      const double c0 = combined.evaluate(p0);
      const double c1 = combined.evaluate(p1);
      const double cm = combined.evaluate(mid);

      if (cm <= c0 && cm <= c1) std::memcpy(best, mid, sizeof(best));
      else if (c0 <= c1) std::memcpy(best, p0, sizeof(best));
      else std::memcpy(best, p1, sizeof(best));
    }

    std::memcpy(cand.pos, best, sizeof(best));
    // Deterministic per-edge tie-break, ~1e-9 of the bbox-diagonal cost
    // scale: flat regions make huge equal-cost plateaus, and
    // std::priority_queue's unspecified tie order then collapses the SAME
    // vertex repeatedly — its valence grows linearly and every collapse
    // re-pushes all its neighbours (measured 116 pushes per collapse,
    // 3.2M heap pops for 28K collapses). The bias spreads collapses evenly
    // (~7 pushes per collapse) and is far below any meaningful error
    // difference or the max_error budget.
    const uint64_t h = (static_cast<uint64_t>(v0) * 0x9E3779B97F4A7C15ull)
                     ^ (static_cast<uint64_t>(v1) * 0xC2B2AE3D27D4EB4Full);
    cand.cost = combined.evaluate(best)
              + scale_sq_ * 1e-9 * (static_cast<double>(h & 0xFFFF) / 65536.0);
    // Vertex quadrics only ever accumulate, so a candidate already over the
    // error budget can never become collapsible: pushing it would only flood
    // the heap with candidates that fail forever as neighbours keep
    // re-queueing them (the dominant churn on boundary-constrained meshes).
    if (max_error_ > 0 && cand.cost > max_error_) return;
    heap_.push(cand);
  }

  bool is_current(const Candidate& c) const {
    return alive_vertex_[c.v0] && alive_vertex_[c.v1]
        && stamps_[c.v0] == c.stamp0 && stamps_[c.v1] == c.stamp1;
  }

  bool would_flip_normal(int v_moving, int v_other, const double* new_pos) const {
    for (int f : vertex_faces_[v_moving]) {
      if (!alive_face_[f]) continue;

      const int* tri = &faces_[static_cast<size_t>(f) * 3];
      // Faces containing both endpoints disappear in the collapse.
      bool shared = false;
      for (int k = 0; k < 3; ++k) shared |= (tri[k] == v_other);
      if (shared) continue;

      const double* p[3];
      for (int k = 0; k < 3; ++k) {
        if (tri[k] == v_moving) {
          p[k] = new_pos;
        } else {
          p[k] = &positions_[static_cast<size_t>(tri[k]) * 3];
        }
      }

      const double* o[3];
      for (int k = 0; k < 3; ++k) o[k] = &positions_[static_cast<size_t>(tri[k]) * 3];

      double before[3], after[3];
      cross_of(o[0], o[1], o[2], before);
      cross_of(p[0], p[1], p[2], after);

      // Degeneracy is judged RELATIVE to edge lengths (sine of the corner
      // angle): float32-quantised flat surfaces are full of noise-scale
      // triangles whose normal direction is meaningless — flip-testing them
      // rejects ~50x more candidates than it accepts (measured). A face
      // whose sine is below 1e-4 has no orientation worth preserving (skip
      // as "before", allow as "after").
      const double before_sq = before[0] * before[0] + before[1] * before[1]
                             + before[2] * before[2];
      const double be1[3] = {o[1][0] - o[0][0], o[1][1] - o[0][1], o[1][2] - o[0][2]};
      const double be2[3] = {o[2][0] - o[0][0], o[2][1] - o[0][1], o[2][2] - o[0][2]};
      const double edge_sq = (be1[0] * be1[0] + be1[1] * be1[1] + be1[2] * be1[2])
                           * (be2[0] * be2[0] + be2[1] * be2[1] + be2[2] * be2[2]);
      if (before_sq <= 1e-8 * edge_sq) continue;

      const double after_sq = after[0] * after[0] + after[1] * after[1]
                            + after[2] * after[2];
      const double ae1[3] = {p[1][0] - p[0][0], p[1][1] - p[0][1], p[1][2] - p[0][2]};
      const double ae2[3] = {p[2][0] - p[0][0], p[2][1] - p[0][1], p[2][2] - p[0][2]};
      const double aedge_sq = (ae1[0] * ae1[0] + ae1[1] * ae1[1] + ae1[2] * ae1[2])
                            * (ae2[0] * ae2[0] + ae2[1] * ae2[1] + ae2[2] * ae2[2]);
      if (after_sq <= 1e-8 * aedge_sq) continue;

      // Reject only true inversions (dot < 0). A zero-area RESULT is
      // allowed: on regular lattices (grid-triangulated depth maps,
      // marching output, float32-quantised positions) collapse targets
      // constantly land exactly on neighbour edges, and treating dot == 0
      // as a flip rejected ~50x more candidates than it accepted (measured
      // 5.3M heap pops for 28K collapses on a flat VGA disc) — transient
      // slivers collapse away in later steps instead.
      const double dot = before[0] * after[0] + before[1] * after[1] + before[2] * after[2];
      if (dot <= 0) return true;
    }

    return false;
  }

  static void cross_of(const double* a, const double* b, const double* c, double* out) {
    const double e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
    const double e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
    out[0] = e1[1] * e2[2] - e1[2] * e2[1];
    out[1] = e1[2] * e2[0] - e1[0] * e2[2];
    out[2] = e1[0] * e2[1] - e1[1] * e2[0];
  }

  bool try_collapse(const Candidate& c, double max_error) {
    const int v0 = c.v0, v1 = c.v1;

    // The flip guard also rejects collapses that create zero-area faces
    // (dot == 0). On regular tessellations (e.g. marching-tetrahedra output
    // on a flat surface) the midpoint/optimal position ALWAYS makes some
    // neighbour collinear, which froze decimation entirely — so when the
    // preferred position fails, fall back to collapsing onto either
    // endpoint before giving up.
    Quadric combined = quadrics_[v0];
    combined.add(quadrics_[v1]);

    const double* attempts[3] = {c.pos,
                                 &positions_[static_cast<size_t>(v0) * 3],
                                 &positions_[static_cast<size_t>(v1) * 3]};
    const double* pos = nullptr;
    for (const double* attempt : attempts) {
      const double cost = combined.evaluate(attempt);
      if (max_error > 0 && cost > max_error) continue;
      if (would_flip_normal(v0, v1, attempt) || would_flip_normal(v1, v0, attempt)) {
        continue;
      }
      pos = attempt;
      break;
    }
    if (pos == nullptr) return false;
    // Note: an endpoint fallback may execute at a cost above
    // the heap minimum (a greedy approximation; with max_error > 0 the
    // per-attempt bound above still applies). Re-queueing at the true cost
    // was tried and churns pathologically on flat meshes where every
    // candidate costs ~0.

    double chosen[3] = {pos[0], pos[1], pos[2]};

    // Move v0 to the chosen position; retire v1.
    std::memcpy(&positions_[static_cast<size_t>(v0) * 3], chosen, 3 * sizeof(double));
    quadrics_[v0].add(quadrics_[v1]);
    alive_vertex_[v1] = false;
    ++stamps_[v0];
    ++stamps_[v1];

    // Rewrite v1 → v0 in v1's faces; kill faces that contained the edge.
    for (int f : vertex_faces_[v1]) {
      if (!alive_face_[f]) continue;

      int* tri = &faces_[static_cast<size_t>(f) * 3];
      bool has_v0 = false;
      for (int k = 0; k < 3; ++k) has_v0 |= (tri[k] == v0);

      if (has_v0) {
        alive_face_[f] = false;
        --live_faces_;
      } else {
        for (int k = 0; k < 3; ++k) {
          if (tri[k] == v1) tri[k] = v0;
        }
        vertex_faces_[v0].push_back(f);
      }
    }
    vertex_faces_[v1].clear();

    // Compact the merged vertex's adjacency: without this, dead faces
    // accumulate for the lifetime of the decimation and the flip-guard
    // scans over vertex_faces_ become O(total collapses) per check —
    // measured 195 s (vs <1 s fixed) to take a flat 57K-face disc to 1K
    // faces, because the few surviving vertices swallow the whole mesh's
    // face history.
    {
      auto& vf = vertex_faces_[v0];
      size_t keep = 0;
      for (int f : vf) {
        if (alive_face_[f]) vf[keep++] = f;
      }
      vf.resize(keep);
    }

    // Refresh candidate edges around the merged vertex.
    std::unordered_set<int> neighbors;
    for (int f : vertex_faces_[v0]) {
      const int* tri = &faces_[static_cast<size_t>(f) * 3];
      for (int k = 0; k < 3; ++k) {
        if (tri[k] != v0 && alive_vertex_[tri[k]]) neighbors.insert(tri[k]);
      }
    }

    for (int nb : neighbors) push_candidate(v0, nb);

    return true;
  }

  std::vector<double> positions_;
  std::vector<int> faces_;
  std::vector<uint32_t> stamps_;
  std::vector<Quadric> quadrics_;
  std::vector<std::vector<int>> vertex_faces_;
  std::vector<bool> alive_vertex_;
  std::vector<bool> alive_face_;
  int live_faces_ = 0;
  double max_error_ = 0.0;
  double scale_sq_ = 0.0;

  std::priority_queue<Candidate, std::vector<Candidate>, std::greater<Candidate>> heap_;
};

}  // namespace

extern "C" {

// Decimate a mesh to `target_faces`. Output buffers must be sized for the
// input mesh (the output never grows). Returns 0 on success.
int hive_qem_decimate(const double* verts, int n_verts,
                      const int* faces, int n_faces,
                      int target_faces, double max_error,
                      double* out_verts, int* out_n_verts,
                      int* out_faces, int* out_n_faces) {
  if (n_verts <= 0 || n_faces <= 0) {
    *out_n_verts = 0;
    *out_n_faces = 0;
    return 0;
  }

  try {
    Decimator decimator(verts, n_verts, faces, n_faces);
    decimator.run(target_faces, max_error);
    decimator.extract(out_verts, out_n_verts, out_faces, out_n_faces);
    return 0;
  } catch (...) {
    return 1;
  }
}

}  // extern "C"
