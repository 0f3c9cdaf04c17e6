// Native host ops for the balanced graph partitioner (gpann_tpu.gp.lp).
//
// Role parity: the reference delegates its partitioning host logic to C++
// (KaMinPar, src/partitioning.cpp:172-199) and parlaylib. The accelerator build keeps
// device compute in XLA; these are the irregular host-side pieces where
// C++ beats NumPy by orders of magnitude:
//   - heavy-edge mutual matching for multilevel coarsening,
//   - greedy BFS region growing for the initial partition,
//   - capacity-repair ("force balance") eviction passes.
//
// C ABI, bound via ctypes (gpann_tpu/native/__init__.py). Single-threaded:
// the build host has one core; heavy parallel work belongs on the accelerator.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <vector>

extern "C" {

// For each node, pick its heaviest neighbor (jittered tie-break), then keep
// mutual pairs whose combined weight fits max_node_w. partner[i] = i when
// unmatched. Returns number of matched pairs.
int64_t heavy_edge_matching(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    const float* weights, const float* node_w, float max_node_w,
    uint64_t seed, int64_t* partner) {
  std::mt19937_64 prng(seed);
  std::uniform_real_distribution<float> jitter(0.0f, 1e-3f);
  std::vector<int64_t> heaviest(n, -1);
  for (int64_t u = 0; u < n; ++u) {
    float best = -1.0f;
    int64_t best_v = -1;
    for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
      float w = weights ? weights[e] + jitter(prng) : 1.0f + jitter(prng);
      if (w > best) {
        best = w;
        best_v = indices[e];
      }
    }
    heaviest[u] = best_v;
  }
  int64_t matched = 0;
  for (int64_t u = 0; u < n; ++u) {
    int64_t v = heaviest[u];
    partner[u] = u;
    if (v >= 0 && v != u && heaviest[v] == u && u < v &&
        node_w[u] + node_w[v] <= max_node_w) {
      ++matched;
    }
  }
  for (int64_t u = 0; u < n; ++u) {
    int64_t v = heaviest[u];
    if (v >= 0 && v != u && heaviest[v] == u &&
        node_w[u] + node_w[v] <= max_node_w) {
      partner[u] = v;
    }
  }
  return matched;
}

// Greedy balanced region growing: BFS-spread seeds, then repeatedly grow the
// lightest part from its frontier (gp/lp.py _initial_partition redesign).
// part must be pre-filled with -1. Returns 0 on success.
int32_t bfs_grow_partition(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    const float* node_w, int32_t k, double cap, uint64_t seed,
    int32_t* part) {
  std::mt19937_64 prng(seed);
  std::vector<int32_t> seeds;
  std::vector<int32_t> dist(n, -1);
  seeds.push_back(static_cast<int32_t>(prng() % n));
  // farthest-point BFS seeding; unreached nodes (other connected components
  // — kNN graphs of clustered data are frequently disconnected) take
  // priority as fresh seeds.
  for (int32_t s = 1; s < k; ++s) {
    std::fill(dist.begin(), dist.end(), -1);
    std::queue<int32_t> bfs;
    for (int32_t v : seeds) {
      dist[v] = 0;
      bfs.push(v);
    }
    int32_t far = seeds.back();
    while (!bfs.empty()) {
      int32_t u = bfs.front();
      bfs.pop();
      far = u;
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int32_t v = indices[e];
        if (dist[v] < 0) {
          dist[v] = dist[u] + 1;
          bfs.push(v);
        }
      }
    }
    int32_t unreached = -1;
    for (int64_t i = 0; i < n; ++i) {
      if (dist[i] < 0) {
        unreached = static_cast<int32_t>(i);
        break;
      }
    }
    if (unreached >= 0) {
      far = unreached;
    } else if (std::find(seeds.begin(), seeds.end(), far) != seeds.end()) {
      far = static_cast<int32_t>(prng() % n);
    }
    seeds.push_back(far);
  }

  std::vector<double> sizes(k, 0.0);
  // per-part frontier queues
  std::vector<std::queue<int32_t>> frontier(k);
  for (int32_t p = 0; p < k; ++p) {
    int32_t s = seeds[p];
    if (part[s] == -1) {
      part[s] = p;
      sizes[p] += node_w[s];
      frontier[p].push(s);
    }
  }
  int64_t assigned = 0;
  for (int64_t i = 0; i < n; ++i) assigned += (part[i] >= 0);

  // priority: grow the lightest part whose frontier still has work; a part
  // with a dead frontier is skipped (not fed scattered nodes) until every
  // frontier is dead, then the lightest part is re-seeded at an unassigned
  // node and grows a fresh contiguous region there.
  int64_t scan_cursor = 0;
  std::vector<bool> frontier_dead(k, false);
  while (assigned < n) {
    int32_t best_p = -1;
    double best_size = 1e300;
    for (int32_t p = 0; p < k; ++p) {
      if (!frontier_dead[p] && sizes[p] < best_size && sizes[p] <= cap) {
        best_size = sizes[p];
        best_p = p;
      }
    }
    if (best_p < 0) {
      // all frontiers dead (or over cap): re-seed the lightest part
      best_p = 0;
      for (int32_t p = 1; p < k; ++p)
        if (sizes[p] < sizes[best_p]) best_p = p;
      while (scan_cursor < n && part[scan_cursor] != -1) ++scan_cursor;
      if (scan_cursor >= n) break;
      int32_t next = static_cast<int32_t>(scan_cursor);
      part[next] = best_p;
      sizes[best_p] += node_w[next];
      frontier[best_p].push(next);
      frontier_dead[best_p] = false;
      ++assigned;
      continue;
    }
    // pop frontier until an unassigned node is found
    int32_t next = -1;
    auto& q = frontier[best_p];
    while (!q.empty()) {
      int32_t u = q.front();
      bool found = false;
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        int32_t v = indices[e];
        if (part[v] == -1) {
          next = v;
          found = true;
          break;
        }
      }
      if (found) break;
      q.pop();
    }
    if (next == -1) {
      frontier_dead[best_p] = true;
      continue;
    }
    part[next] = best_p;
    sizes[best_p] += node_w[next];
    frontier[best_p].push(next);
    ++assigned;
  }
  return 0;
}

// Evict lowest-affinity nodes from overweight parts into the closest
// (highest-affinity) part with room. Modifies part in place.
int32_t force_balance(
    int64_t n, const int64_t* indptr, const int32_t* indices,
    const float* weights, const float* node_w, int32_t k, double cap,
    int32_t* part) {
  std::vector<double> sizes(k, 0.0);
  for (int64_t i = 0; i < n; ++i) sizes[part[i]] += node_w[i];
  bool any_over = false;
  for (int32_t p = 0; p < k; ++p) any_over |= (sizes[p] > cap);
  if (!any_over) return 0;

  std::vector<float> aff(k, 0.0f);
  // order parts by overweight descending
  std::vector<int32_t> order(k);
  for (int32_t p = 0; p < k; ++p) order[p] = p;
  std::sort(order.begin(), order.end(),
            [&](int32_t a, int32_t b) { return sizes[a] > sizes[b]; });

  for (int32_t p : order) {
    if (sizes[p] <= cap) continue;
    // collect members with their affinity to p
    std::vector<std::pair<float, int64_t>> members;  // (own affinity, node)
    for (int64_t u = 0; u < n; ++u) {
      if (part[u] != p) continue;
      float own = 0.0f;
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        if (part[indices[e]] == p) own += weights ? weights[e] : 1.0f;
      }
      members.emplace_back(own, u);
    }
    std::sort(members.begin(), members.end());
    for (auto& [own, u] : members) {
      if (sizes[p] <= cap) break;
      // best target by affinity with room
      std::fill(aff.begin(), aff.end(), 0.0f);
      for (int64_t e = indptr[u]; e < indptr[u + 1]; ++e) {
        aff[part[indices[e]]] += weights ? weights[e] : 1.0f;
      }
      int32_t best_t = -1;
      float best_a = -1.0f;
      for (int32_t t = 0; t < k; ++t) {
        if (t == p || sizes[t] + node_w[u] > cap) continue;
        if (aff[t] > best_a) {
          best_a = aff[t];
          best_t = t;
        }
      }
      if (best_t < 0) {
        // dump into globally lightest part
        best_t = 0;
        for (int32_t t = 1; t < k; ++t)
          if (sizes[t] < sizes[best_t]) best_t = t;
        if (best_t == p) continue;
      }
      part[u] = best_t;
      sizes[best_t] += node_w[u];
      sizes[p] -= node_w[u];
    }
  }
  return 0;
}

}  // extern "C"
