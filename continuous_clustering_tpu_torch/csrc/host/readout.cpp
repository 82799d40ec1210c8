// Publish-path host assembly: packed readout slab -> structured point cloud.
//
// The reference assembles its published PointCloud2 record-by-record in C++
// (columnToPointCloud / clusterToPointCloud, src/ros/ros_utils.cpp:34-107);
// the NumPy equivalent (26 per-field strided stores into a structured array,
// then fancy-indexed filter + argsort + split for cluster grouping) costs
// ~45 ms per 512-column window and caps the streaming pipeline well below
// the device rate.  This module does both jobs in one pass over the slab.
//
// Layout contracts (asserted from Python at load):
//  * slab: (n_slab_rows, R, W) int32, C-contiguous; row order must match
//    ops/readout.py (v3 layout: PK8 byte-packs intensity/ground/debug/
//    ignored, gcol is derived as isnan(distance) ? -1 : from_gcol + c, the
//    nbr_stats row exists only when record_neighbor_stats is on, and the
//    component-slot join happens HERE via the (2, K) join tables the step
//    exports — on device the join cost three window-scale gathers
//    ~1.3 ms/step; here it is one cache-resident table lookup per record)
//  * out:  packed records matching io/point_cloud.py POINT_DTYPE (26 fields)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

#pragma pack(push, 1)
struct PointRecord {  // io/point_cloud.py POINT_DTYPE, packed (itemsize 116)
    float x, y, z;
    int64_t firing_index;
    uint8_t intensity;
    uint64_t globally_unique_point_index;
    uint32_t time_sec, time_nsec;
    float distance, azimuth_angle, inclination_angle;
    double continuous_azimuth_angle;
    int64_t global_column_index;
    uint16_t local_column_index, row_index;
    uint8_t ground_point_label, debug_ground_point_label;
    float height_over_ground;
    uint8_t ignore_for_clustering;
    double finished_at_continuous_azimuth_angle;
    uint16_t num_child_points;
    uint16_t tree_root_row_index;
    int64_t tree_root_column_index;
    uint32_t number_of_visited_neighbors;
    uint64_t tree_id, id;
};
#pragma pack(pop)
static_assert(sizeof(PointRecord) == 116, "POINT_DTYPE layout drift");

// slab row indices; must match ops/readout.py FETCH_ORDER (+ optional nbr)
enum SlabRow {
    SR_X = 0, SR_Y, SR_Z, SR_DISTANCE, SR_AZIMUTH, SR_INCLINATION,
    SR_CONT_AZ, SR_FINISH_AZ,
    SR_STAMP_LO, SR_STAMP_HI, SR_UIDX_LO, SR_UIDX_HI,
    SR_PK8, SR_FIRING_INDEX, SR_SLOT,
    SR_COUNT,                 // base layout (no neighbor stats)
    SR_NBR_STATS = SR_COUNT,  // optional trailing row
};

inline float as_f32(int32_t v) {
    float f;
    std::memcpy(&f, &v, sizeof(f));
    return f;
}

// Division-free quotient by the runtime ring width: quotients here are tiny
// (a row index < 2^16), so a double reciprocal multiply plus a one-step
// fixup is exact and ~10x cheaper than a 64-bit hardware divide per record
// (the assemble loop is row-index arithmetic bound otherwise).
struct DivRc {
    int64_t rc;
    double inv;
    explicit DivRc(int64_t rc_) : rc(rc_), inv(1.0 / (double)rc_) {}
    inline int64_t quot(int64_t v) const {
        int64_t q = (int64_t)((double)v * inv);
        q -= (q * rc > v);
        q += ((q + 1) * rc <= v);
        return q;
    }
};

// Fill one record from slab cell (r, w); lcol is the precomputed local
// column index and g the global column index of the output column.
// tab_cid / tab_rep are the (K,) per-slot join tables (cluster id and
// representative glid of the slot's resolved component).
inline void fill_record(const int32_t* slab, bool has_nbr, int64_t plane,
                        int64_t R, int64_t W, int64_t r, int64_t w,
                        uint16_t lcol, int64_t g, const DivRc& drc,
                        double origin_az, const int32_t* tab_cid,
                        const int32_t* tab_rep, PointRecord* out) {
    const int64_t cell = r * W + w;
    auto row = [&](int sr) { return slab[sr * plane + cell]; };

    out->x = as_f32(row(SR_X));
    out->y = as_f32(row(SR_Y));
    out->z = as_f32(row(SR_Z));
    out->firing_index = row(SR_FIRING_INDEX);
    const uint32_t pk8 = (uint32_t)row(SR_PK8);
    out->intensity = (uint8_t)(pk8 & 0xFF);
    out->globally_unique_point_index =
        ((uint64_t)(uint32_t)row(SR_UIDX_HI) << 32) | (uint32_t)row(SR_UIDX_LO);
    uint64_t stamp =
        ((uint64_t)(uint32_t)row(SR_STAMP_HI) << 32) | (uint32_t)row(SR_STAMP_LO);
    out->time_sec = (uint32_t)(stamp / 1000000000ull);
    out->time_nsec = (uint32_t)(stamp % 1000000000ull);
    const float dist = as_f32(row(SR_DISTANCE));
    out->distance = dist;
    out->azimuth_angle = as_f32(row(SR_AZIMUTH));
    out->inclination_angle = as_f32(row(SR_INCLINATION));
    out->continuous_azimuth_angle = (double)as_f32(row(SR_CONT_AZ)) + origin_az;
    // gcol is not transmitted: ingest stores the column index for data-
    // holding cells and -1 for NaN-distance cells (ops/ingest.py; clears
    // reset gcol together with distance, ops/state.py CLEAR_VALUES)
    out->global_column_index = std::isnan(dist) ? -1 : g;
    out->local_column_index = lcol;
    out->row_index = (uint16_t)r;
    out->ground_point_label = (uint8_t)((pk8 >> 8) & 0xFF);
    out->debug_ground_point_label = (uint8_t)((pk8 >> 16) & 0xFF);
    out->height_over_ground = std::nanf("");
    out->ignore_for_clustering = (uint8_t)((pk8 >> 24) & 0xFF);
    out->finished_at_continuous_azimuth_angle =
        (double)as_f32(row(SR_FINISH_AZ)) + origin_az;
    const int32_t nbr = has_nbr ? row(SR_NBR_STATS) : 0;
    out->num_child_points = (uint16_t)((uint32_t)nbr >> 16);
    const int32_t slot = row(SR_SLOT);
    const int64_t rep = slot >= 0 ? (int64_t)tab_rep[slot] : -1;
    const int64_t rep0 = rep < 0 ? 0 : rep;
    int64_t q = drc.quot(rep0);
    out->tree_root_row_index = (uint16_t)q;
    out->tree_root_column_index = rep0 - q * drc.rc;
    out->number_of_visited_neighbors = (uint32_t)(nbr & 0xFFFF);
    out->tree_id = (uint64_t)rep0;
    out->id = slot >= 0 ? (uint64_t)(uint32_t)tab_cid[slot] : 0;
}

}  // namespace

extern "C" {

int64_t cct_readout_record_size() { return (int64_t)sizeof(PointRecord); }
int64_t cct_readout_layout_version() { return 3; }

// Assemble records for slab columns [off, off+n), flattened column-major
// (record index = c * R + r), mirroring models/continuous_clustering.py
// get_columns at stage CONTINUOUS_CLUSTERING.  tabs = (2, K) i32 join
// tables (row 0 = cid by slot, row 1 = rep by slot), K = tab_k.
void cct_assemble_cloud(const int32_t* slab, int64_t n_slab_rows, int64_t R,
                        int64_t W, const int32_t* tabs, int64_t tab_k,
                        int64_t off, int64_t n, int64_t from_gcol,
                        int64_t rc, double origin_az, void* out_records) {
    const bool has_nbr = n_slab_rows > SR_COUNT;
    PointRecord* out = (PointRecord*)out_records;
    const int64_t plane = R * W;
    const DivRc drc(rc);
    const int32_t* tab_cid = tabs;
    const int32_t* tab_rep = tabs + tab_k;
    const int64_t lcol0 = (int64_t)((uint64_t)from_gcol % (uint64_t)rc);
    // r outer / c inner: slab reads are contiguous n-length runs per plane
    // row (the c-outer order makes ~15 strided 2KB-stride read streams and
    // is ~2x slower; the single strided record-write stream is cheaper)
    for (int64_t r = 0; r < R; ++r) {
        int64_t lcol = lcol0;
        for (int64_t c = 0; c < n; ++c) {
            fill_record(slab, has_nbr, plane, R, W, r, off + c,
                        (uint16_t)lcol, from_gcol + c, drc, origin_az,
                        tab_cid, tab_rep, out + c * R + r);
            lcol = lcol + 1 == rc ? 0 : lcol + 1;
        }
    }
}

// Cluster emission: select cells with counter_old <= id < counter_new,
// stable-sort by id, drop groups of <= 20 points (reference publish gate,
// src/clustering/continuous_clustering.cpp:1023), and write the surviving
// groups' records contiguously.  Returns the number of groups; group g's
// records are out_records[group_off[g] : group_off[g+1]] with its cluster
// stamp in out_group_stamp[g] (last point or mid-range per
// use_last_point_for_cluster_stamp).  Mirrors _emit_clusters exactly.
//
// Dense selections assemble the WHOLE window once into the caller-provided
// out_full buffer (R*n records; pass null to use a scratch buffer) and then
// copy 116-byte records; *out_dense reports whether out_full was filled so
// the caller can reuse the window assembly (get_columns serves overlapping
// ranges of the same window every consumed step).
int64_t cct_emit_clusters(const int32_t* slab, int64_t n_slab_rows, int64_t R,
                          int64_t W, const int32_t* tabs, int64_t tab_k,
                          int64_t off, int64_t n, int64_t from_gcol,
                          int64_t rc, double origin_az, int64_t counter_old,
                          int64_t counter_new, int use_last_stamp,
                          void* out_records, int64_t* out_group_off,
                          uint64_t* out_group_stamp, void* out_full,
                          int32_t* out_dense) {
    const bool has_nbr = n_slab_rows > SR_COUNT;
    const int64_t plane = R * W;
    const int32_t* slot_row = slab + (int64_t)SR_SLOT * plane;
    const int32_t* tab_cid = tabs;
    const int32_t* tab_rep = tabs + tab_k;
    if (out_dense) *out_dense = 0;

    // (id << 32 | flat column-major record ordinal) for selected cells:
    // sorting the packed u64 == NumPy's stable argsort by id over the
    // column-major flattened cloud (ordinal is the tiebreak); ids are
    // cluster-counter values < 2^31 and ordinals < R*W < 2^32
    std::vector<uint64_t> sel;
    sel.reserve((size_t)(R * n / 4));
    for (int64_t r = 0; r < R; ++r) {
        const int32_t* row = slot_row + r * W + off;
        for (int64_t c = 0; c < n; ++c) {
            const int32_t slot = row[c];
            if (slot < 0) continue;
            const int64_t id = (int64_t)(uint32_t)tab_cid[slot];
            if (id >= counter_old && id < counter_new)
                sel.push_back(((uint64_t)id << 32) | (uint64_t)(c * R + r));
        }
    }
    if (sel.empty()) return 0;
    {
        // LSD radix sort on the packed keys (11-bit digits, passes above
        // the maximum key skipped): ~5x cheaper than std::sort at window
        // scale and the sort was half the dense-emit cost
        uint64_t mx = 0;
        for (uint64_t k : sel) mx = k > mx ? k : mx;
        thread_local std::vector<uint64_t> tmp;
        tmp.resize(sel.size());
        uint64_t* a = sel.data();
        uint64_t* b = tmp.data();
        for (int shift = 0; shift < 64 && (mx >> shift); shift += 11) {
            uint32_t hist[2048] = {0};
            const size_t m = sel.size();
            for (size_t k = 0; k < m; ++k) ++hist[(a[k] >> shift) & 2047];
            uint32_t sum = 0;
            for (uint32_t& h : hist) {
                uint32_t cnt = h;
                h = sum;
                sum += cnt;
            }
            for (size_t k = 0; k < m; ++k) b[hist[(a[k] >> shift) & 2047]++] = a[k];
            std::swap(a, b);
        }
        if (a != sel.data())
            std::memcpy(sel.data(), a, sel.size() * sizeof(uint64_t));
    }

    PointRecord* out = (PointRecord*)out_records;
    const DivRc drc(rc);

    // dense selections (the publish-everything probe, big windows): one
    // streaming assemble of the whole window then 116-byte record copies
    // beats filling each record in sorted (scattered) order
    thread_local std::vector<PointRecord> scratch;
    const bool dense = (int64_t)sel.size() * 4 > R * n;
    PointRecord* full = nullptr;
    if (dense) {
        if (out_full) {
            full = (PointRecord*)out_full;
            if (out_dense) *out_dense = 1;
        } else {
            scratch.resize((size_t)(R * n));
            full = scratch.data();
        }
        cct_assemble_cloud(slab, n_slab_rows, R, W, tabs, tab_k, off, n,
                           from_gcol, rc, origin_az, full);
    }

    int64_t n_groups = 0, written = 0;
    size_t i = 0;
    while (i < sel.size()) {
        size_t j = i;
        const uint64_t id_hi = sel[i] >> 32;
        while (j < sel.size() && (sel[j] >> 32) == id_hi) ++j;
        if ((int64_t)(j - i) > 20) {
            const int64_t start = written;
            uint64_t smin = UINT64_MAX, smax = 0;
            for (size_t k = i; k < j; ++k) {
                const int64_t ord = (int64_t)(uint32_t)sel[k];
                PointRecord* rec = out + written++;
                if (dense) {
                    *rec = full[(size_t)ord];
                } else {
                    const int64_t r = ord % R, c = ord / R;
                    const int64_t g = from_gcol + c;
                    const uint16_t lcol = (uint16_t)(g - drc.quot(g) * rc);
                    fill_record(slab, has_nbr, plane, R, W, r, off + c, lcol,
                                g, drc, origin_az, tab_cid, tab_rep, rec);
                }
                const uint64_t stamp =
                    (uint64_t)rec->time_sec * 1000000000ull + rec->time_nsec;
                smin = stamp < smin ? stamp : smin;
                smax = stamp > smax ? stamp : smax;
            }
            out_group_off[n_groups] = start;
            out_group_stamp[n_groups] =
                use_last_stamp ? smax : smin + (smax - smin) / 2;
            ++n_groups;
        }
        i = j;
    }
    out_group_off[n_groups] = written;
    return n_groups;
}

}  // extern "C"
