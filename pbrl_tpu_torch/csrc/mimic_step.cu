// mimic_step.cu -- one humanoid policy step (all physics substeps) per launch.
//
// Replaces the TPU kernel pbrl_tpu/ops/mimic_kernel.py::_kernel (the
// pl.pallas_call at mimic_kernel.py:144), whose body is the field program of
// pbrl_tpu/ops/field_physics.py: `substep` run n_substeps times (FK, body
// velocities, spatial inertias, CRBA on the ancestor pairs, RNEA bias, a
// leaves-first tree Cholesky with a reciprocal diagonal, 141 static contact
// slots in 10 kinds with exact Delassus masses, joint limits, implicit-PD or
// torque right-hand side, semi-implicit Euler), then `fk_outputs` and the
// fall flag (max over substeps).  Its plain version is
// pbrl_tpu_torch/ops/field_physics.py.
//
// Bound (H100 SXM, 67 TFLOP/s f32 without tensor cores, 3.35 TB/s): at most
// 500,858 FLOPs per env per policy step (field_physics.count_policy_step_flops:
// the entry substep that solves the self-contact masses, 7 that reuse them,
// the final FK, clamps and selects included), so at 4096 envs at most about
// 2.05 GFLOP, about 31 us: compute-bound.  A contact's Delassus mass is
// needed only where it touches, so the count for given inputs is lower
// (count_policy_step_flops(spec, contact_activity(...)); at least 375,783).  Bytes are about 1 KB per env in and out
// (qpos, qvel, u; qpos, qvel, xpos, xquat, fall), about 4 MB, about 1.3 us.
// No tensor cores: one env is a 34-dof sparse tree (310 ancestor pairs, 141
// contact slots with supports of at most 20 dofs), which holds no dense
// product that wgmma could take, so the bound is the f32 CUDA-core rate.
//
// Design.  One warp (LANES = 32 lanes) per env; 16 lanes per env took
// about a quarter longer on the card (PERF.md).  A persistent grid of one block per SM;
// each block stages the index lists that the serial chains walk (struct
// Hot, 53 KB) into shared memory once, and its warps (MAX_WARPS = 12: 13
// and 9-11 were slower) each walk their envs; a ragged tail of B leaves
// whole warps without an env, so B needs no padding.  The env's working state (struct
// Work, 14 KB: qpos, qvel, u, body frames, S, cvel, inertias, both factors,
// bias, forces, held self masses, and per stage a union of scratch) lives in
// shared memory, so no stage touches local memory.  Stages run across the
// lanes:
//   - FK, body velocities and RNEA by tree level (bodies of one level in
//     parallel; body 0 first, alone, since it sets the origin);
//   - spatial inertias, the CRBA pairs, the per-dof right-hand side (limit,
//     bias, damping, actuator) and the Euler update over lanes;
//   - contact slots in rounds of 32 lanes that keep a kind's slots together
//     (fewer code paths per warp): geometry, relative velocity, the force,
//     and the Delassus solve, in a per-lane scratch sized to the slot's
//     support, only where it changes the force (an active contact, or the
//     'step' masses held at the entry substep);
//   - both Cholesky factors (of M for the Delassus masses, of M plus the
//     implicit diagonal for the solve) at once, by body level: one pass over
//     the lanes takes the terms of descendant bodies, then right-looking
//     steps inside each body; the forward solve pushes over a dof's
//     ancestors, the backward solve pulls by tree depth.
// Sums keep the serial program's order: per-slot spatial forces go to
// Work::sf and each body sums its own slot list in slot order (no atomics),
// subtree sums walk children in descending index, each factor entry takes
// its terms in descending dof order.  Two launches give the same bits, and
// so do the one-thread-per-env kernel this one replaced and the host build.
//
// The model is a table (struct Model, packed by field_physics.pack_spec):
// what a stage reads once per body, joint, geom or slot comes from global
// memory through the read-only path; lanes of a warp read different
// entries, so none of it is __constant__.
//
// What it leaves: one env's step is still a chain of dependent shared-
// memory loads: the tree levels (4), the factor's 15 in-body steps, the
// forward solve's 34 steps, each lane's Delassus elimination (serial over
// its support), and the entry substep's 104 self-contact solves.  Shared
// memory holds 12 envs per SM, so 4096 envs take three rounds.

// One source, two builds.  The device code is plain C++ behind a few macros:
// compiled without nvcc (g++ -x c++) NLANE is 1, lane 0 and SYNC() a no-op,
// and it gives a host function mimic_step_host that the CPU tests use to
// check every index and formula against the plain version.  Races between
// lanes show only on the card (two launches must give the same bits).

#include <math.h>
#include <stddef.h>

// Lanes per env on the card: one warp.  pack_spec lays out the contact slots
// (slot_order) in rounds of LANES.
#define LANES 32

#ifdef __CUDACC__
#include <cuda_runtime.h>
#include <atomic>
#define NLANE LANES
#define DEV __device__ __forceinline__
#define SYNC() __syncwarp()
#define RSQRT(x) rsqrtf(x)
#else
#define NLANE 1
#define DEV static inline
#define SYNC() ((void)0)
#define __restrict__ __restrict
#define RSQRT(x) (1.0f / sqrtf(x))
#endif

// ---------------------------------------------------------------------------
// Model table.  The MAX* limits, MODEL_FIELDS and HOT_FIELDS are the one
// definition of its layout: pbrl_tpu_torch/ops/field_physics.py reads them
// from this file to pack the table, and the wrapper compares its offsets
// with mimic_model_offsets of the built library at load time.
// ---------------------------------------------------------------------------

#define MAXB 16
#define MAXJ 32
#define MAXQ 48
#define MAXV 40
#define MAXU 32
#define MAXG 24
#define MAXP 320
#define MAXS 144
#define MAXL 32
#define MAXSUPP 2176
#define MAXSL 20
#define MAXFU 1536
#define MAXDL 14336

// Read once per slot, body, joint or geom per substep: from global memory
// through the read-only path.
#define MODEL_FIELDS(X) \
  X(int, nq, 1) X(int, nv, 1) X(int, nu, 1) X(int, nbody, 1) X(int, njnt, 1) \
  X(int, ngeom, 1) X(int, nslot, 1) X(int, nslot_order, 1) X(int, npair, 1) X(int, nlevel, 1) \
  X(int, ndepth, 1) \
  X(int, mode, 1) X(int, n_substeps, 1) X(int, self_mass, 1) X(int, self_friction, 1) \
  X(float, dt, 1) X(float, gravity, 3) X(float, kstiff, 1) X(float, bdamp, 1) \
  X(float, fric_gain, 1) X(float, lk, 1) X(float, lb, 1) \
  X(int, body_parent, MAXB) X(int, body_jnt_start, MAXB) X(int, body_jnt_count, MAXB) \
  X(int, body_dof_start, MAXB) X(int, body_dof_count, MAXB) \
  X(float, body_pos, MAXB * 3) X(float, body_quat, MAXB * 4) X(float, body_mass, MAXB) \
  X(float, body_subtree_mass, MAXB) X(float, body_ipos, MAXB * 3) X(float, body_inertia, MAXB * 9) \
  X(int, jnt_type, MAXJ) X(int, jnt_qadr, MAXJ) X(int, jnt_dadr, MAXJ) \
  X(float, jnt_axis, MAXJ * 3) X(float, jnt_pos, MAXJ * 3) \
  X(float, dof_armature, MAXV) X(float, dof_damping, MAXV) X(float, dof_extra_diag, MAXV) \
  X(int, geom_body, MAXG) X(float, geom_pos, MAXG * 3) X(float, geom_quat, MAXG * 4) \
  X(float, geom_size, MAXG * 3) \
  X(int, slot_kind, MAXS) X(int, slot_g1, MAXS) X(int, slot_g2, MAXS) X(int, slot_b1, MAXS) \
  X(int, slot_b2, MAXS) X(int, slot_fall, MAXS) X(int, slot_static, MAXS) \
  X(float, slot_friction, MAXS) X(float, slot_meff, MAXS) X(float, slot_extra, MAXS * 3) \
  X(float, slot_frame, MAXS * 9) X(float, slot_d0, MAXS) \
  X(int, act_qadr, MAXU) X(float, act_kp, MAXU) X(float, act_kd, MAXU) \
  X(float, act_lo, MAXU) X(float, act_hi, MAXU) \
  X(int, lim_qadr, MAXL) X(float, lim_lo, MAXL) X(float, lim_hi, MAXL)

// The index lists that the serial chains walk (tree levels, the factor and
// solves, the Delassus eliminations, the force sums): the block stages them
// into shared memory once.  They follow MODEL_FIELDS in the table.
#define HOT_FIELDS(X) \
  X(int, lvl_ptr, MAXB + 1) X(int, lvl_body, MAXB) \
  X(int, child_ptr, MAXB + 1) X(int, child, MAXB) \
  X(int, body_slot_ptr, MAXB + 1) X(int, body_slot, 2 * MAXS) \
  X(int, dof_body, MAXV) X(int, dof_lim, MAXV) X(int, dof_act, MAXV) \
  X(int, dep_ptr, MAXV + 1) X(int, dep_dof, MAXV) \
  X(int, pair_i, MAXP) X(int, pair_j, MAXP) \
  X(int, anc_ptr, MAXV + 1) X(int, anc_dof, MAXP) X(int, anc_pair, MAXP) \
  X(int, fa_ptr, MAXB + 1) X(int, fa_ent, MAXP) X(int, fa_op_ptr, MAXP + 1) \
  X(int, fa_op, MAXFU) X(int, fl_step_ptr, MAXB + 1) X(int, fb_piv_ptr, MAXV + 1) \
  X(int, fb_piv, MAXV) X(int, fb_upd_ptr, MAXV + 1) X(int, fb_upd, MAXP) \
  X(int, slot_order, 2 * MAXS) X(int, slot_supp_start, MAXS) X(int, slot_supp_count, MAXS) \
  X(int, slot_dl_end, MAXS) X(int, dl_pos, MAXDL / 4) \
  X(int, supp_dof, MAXSUPP) X(int, supp_sign, MAXSUPP)

// Field notes.  lvl_body lists the bodies by tree level (lvl_ptr[l] ..
// lvl_ptr[l + 1]), body 0 alone at level 0.  child lists each body's
// children in descending index.  body_slot lists, per body, the slots that
// push on it in ascending slot order as 2 * slot (body2) or 2 * slot + 1
// (body1).  dof_lim / dof_act is the limit / actuator acting on a dof, or -1.
// dep_dof lists the dofs by depth (number of ancestor dofs).  The factor runs
// by body level (lvl_ptr): fa_ent lists the entries (k, i), k a dof of a
// body of level l (fa_ptr[l] .. fa_ptr[l + 1]) and i = k or an ancestor, as
// pair(k, i) | k << 10 | (i == k) << 16, each with the terms of the dofs c of
// descendant bodies (fa_op_ptr[e] ..) as pair(c, i) | pair(c, k) << 10 in
// descending c.  Level l's steps (fl_step_ptr[l] ..) factor the bodies' own
// dofs, last first: step s pivots the dofs fb_piv (k | pair(k, k) << 8) and
// applies their rank-1 updates fb_upd (target | pair(k, a) << 10 |
// pair(k, b) << 20, a of k's body).  slot_order lays
// the slots out in rounds of 32 lanes (-1: an idle lane): slots of one kind
// share a round where they fit, so fewer kinds' code paths run one after the
// other in a warp, and the ground slots come first.  dl_pos holds a byte per
// (slot, support entry, ancestor of its dof in anc_dof order): the
// ancestor's position in the slot's support; a slot's bytes end at
// slot_dl_end.

#define DECL_FIELD(t, n, c) t n[c];
struct Hot {
  HOT_FIELDS(DECL_FIELD)
};
struct Model {
  MODEL_FIELDS(DECL_FIELD)
  Hot hot;
};

enum { J_FREE = 0, J_HINGE = 1, J_SLIDE = 2 };
enum { MODE_PD = 0, MODE_TORQUE = 1 };
enum { SELF_STEP = 0, SELF_SUBSTEP = 1, SELF_STATIC = 2 };
enum {
  K_PLANE_SPHERE = 0, K_PLANE_CAPEND, K_PLANE_CORNER, K_SPHERE_SPHERE,
  K_SPHERE_CAPSULE, K_SPHERE_BOX, K_CAPSULE_CAPSULE, K_CAPSULE_BOX,
  K_BOXCORNER_BOX, K_BOX_BOXCORNER
};

#ifdef __CUDACC__
typedef float2 Pair;
#else
struct Pair {
  float x, y;
};
#endif

// Working state of one env (shared memory on the card).  The union holds
// what one stage needs and the next stages do not.
struct Work {
  Pair L[MAXP];  // .x: M, then its factor (contacts); .y: M + the implicit
                 // diagonal, then its factor (the acceleration solve)
  float qpos[MAXQ], qvel[MAXV], u[MAXU];
  float xpos[MAXB][3], xquat[MAXB][4];
  float S[MAXV][6];
  float origin[4];
  float cvel[MAXB][6];
  float A[MAXB][9], h[MAXB][3];      // body spatial inertia about the origin
  float invd0[MAXV], invd1[MAXV];    // 1 / diagonal of the two factors
  float mdiag[MAXV];                 // M's diagonal (joint limits)
  float bias[MAXV], qfrc[MAXV], y[MAXV];
  float facc[MAXB][6];
  float held[MAXS];
  union {
    float racc[MAXB][6];             // accelerations
    struct {                         // bodies_up, mass_matrix_bias
      float cAh[MAXB][12];             // composite (subtree) inertia: A, h
      float F[MAXV][6];                // composite inertia times S_i
    };
    struct {                         // contacts
      float gpos[MAXG][3], gquat[MAXG][4];
      float sf[MAXS][6];               // per-slot spatial force (torque, force)
      float lane_acc[MAXSL][NLANE];    // each lane's Delassus scratch
    };
  };
};

// ---------------------------------------------------------------------------
// Small vector / quaternion helpers (same formulas as the field program)
// ---------------------------------------------------------------------------

DEV void v3_set(float* o, float x, float y, float z) { o[0] = x; o[1] = y; o[2] = z; }
DEV void v3_copy(float* o, const float* a) { o[0] = a[0]; o[1] = a[1]; o[2] = a[2]; }
DEV float v3_dot(const float* a, const float* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }
DEV void v3_cross(float* o, const float* a, const float* b) {
  float x = a[1] * b[2] - a[2] * b[1];
  float y = a[2] * b[0] - a[0] * b[2];
  float z = a[0] * b[1] - a[1] * b[0];
  o[0] = x; o[1] = y; o[2] = z;
}

DEV void q_mul(float* o, const float* a, const float* b) {
  float w1 = a[0], x1 = a[1], y1 = a[2], z1 = a[3];
  float w2 = b[0], x2 = b[1], y2 = b[2], z2 = b[3];
  o[0] = w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2;
  o[1] = w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2;
  o[2] = w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2;
  o[3] = w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2;
}

DEV void q_normalize(float* q) {
  float nsq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  float n = RSQRT(fmaxf(nsq, 1e-12f));
  q[0] *= n; q[1] *= n; q[2] *= n; q[3] *= n;
}

// R(q) v via v + 2 (w (u x v) + u x (u x v))
DEV void q_rotate(float* o, const float* q, const float* v) {
  float u[3] = {q[1], q[2], q[3]};
  float uv[3], uuv[3];
  v3_cross(uv, u, v);
  v3_cross(uuv, u, uv);
  float w = q[0];
  float x = v[0] + 2.0f * (w * uv[0] + uuv[0]);
  float y = v[1] + 2.0f * (w * uv[1] + uuv[1]);
  float z = v[2] + 2.0f * (w * uv[2] + uuv[2]);
  o[0] = x; o[1] = y; o[2] = z;
}

DEV void q_rotate_inv(float* o, const float* q, const float* v) {
  float qc[4] = {q[0], -q[1], -q[2], -q[3]};
  q_rotate(o, qc, v);
}

// rows of R(q)
DEV void q_to_mat(float r[3][3], const float* q) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float xx = x * x, yy = y * y, zz = z * z, xy = x * y, xz = x * z, yz = y * z;
  float wx = w * x, wy = w * y, wz = w * z;
  r[0][0] = 1.0f - 2.0f * (yy + zz); r[0][1] = 2.0f * (xy - wz); r[0][2] = 2.0f * (xz + wy);
  r[1][0] = 2.0f * (xy + wz); r[1][1] = 1.0f - 2.0f * (xx + zz); r[1][2] = 2.0f * (yz - wx);
  r[2][0] = 2.0f * (xz - wy); r[2][1] = 2.0f * (yz + wx); r[2][2] = 1.0f - 2.0f * (xx + yy);
}

// spatial motion cross product v x m (6-vectors: angular, linear)
DEV void sp_motion_cross(float* o, const float* v, const float* m) {
  float a[3], b1[3], b2[3];
  v3_cross(a, v, m);
  v3_cross(b1, v, m + 3);
  v3_cross(b2, v + 3, m);
  o[0] = a[0]; o[1] = a[1]; o[2] = a[2];
  o[3] = b1[0] + b2[0]; o[4] = b1[1] + b2[1]; o[5] = b1[2] + b2[2];
}

DEV float sp_dot(const float* a, const float* b) {
  float acc = 0.0f;
  for (int k = 0; k < 6; ++k) acc += a[k] * b[k];
  return acc;
}

// I s for the structured inertia (A symmetric 3x3 as 9 entries, upper triangle
// read, h = m c, m): force (A w + h x v, m v - h x w)
DEV void inertia_mul(float* o, const float* A, const float* h, float m, const float* s) {
  const float* w = s;
  const float* v = s + 3;
  float aw0 = A[0] * w[0] + A[1] * w[1] + A[2] * w[2];
  float aw1 = A[1] * w[0] + A[4] * w[1] + A[5] * w[2];
  float aw2 = A[2] * w[0] + A[5] * w[1] + A[8] * w[2];
  float hv[3], hw[3];
  v3_cross(hv, h, v);
  v3_cross(hw, h, w);
  o[0] = aw0 + hv[0]; o[1] = aw1 + hv[1]; o[2] = aw2 + hv[2];
  o[3] = v[0] * m - hw[0]; o[4] = v[1] * m - hw[1]; o[5] = v[2] * m - hw[2];
}

// Max of x over the env's lanes (every lane calls it).
DEV float warp_max(float x) {
#ifdef __CUDACC__
  for (int off = NLANE / 2; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
#endif
  return x;
}

// In-place subtree sums of the per-body forces (leaves first, by level):
// facc[b] += facc[c] for each child c in descending index, as the serial
// loop `for b = nb-1..0: facc[parent(b)] += facc[b]` adds them.
DEV void force_subtree_sums(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w,
                            int lane) {
  for (int l = m->nlevel[0] - 2; l >= 0; --l) {
    const int b0 = H->lvl_ptr[l], cnt = (H->lvl_ptr[l + 1] - b0) * 6;
    for (int t = lane; t < cnt; t += NLANE) {
      const int b = H->lvl_body[b0 + t / 6], c = t % 6;
      float acc = w.facc[b][c];
      for (int k = H->child_ptr[b]; k < H->child_ptr[b + 1]; ++k) acc += w.facc[H->child[k]][c];
      w.facc[b][c] = acc;
    }
    SYNC();
  }
}

// ---------------------------------------------------------------------------
// Kinematics (field_physics._fk, _cvel, _spatial_inertias)
// ---------------------------------------------------------------------------

// Frame and motion-subspace rows of body b, its parent done.  Body 0 sets the
// origin (its first free joint's position, else its own position).
DEV void fk_body(const Model* __restrict__ m, Work& w, int b) {
  int origin_set = b != 0;
  if (b == 0) v3_set(w.origin, 0.0f, 0.0f, 0.0f);
  const float* origin = w.origin;
  const int parent = m->body_parent[b];
  float pq[4] = {1.0f, 0.0f, 0.0f, 0.0f};
  float pp[3] = {0.0f, 0.0f, 0.0f};
  if (parent >= 0) {
    for (int k = 0; k < 4; ++k) pq[k] = w.xquat[parent][k];
    v3_copy(pp, w.xpos[parent]);
  }
  float bq[4], bp[3], t[3];
  q_mul(bq, pq, &m->body_quat[4 * b]);
  q_rotate(t, pq, &m->body_pos[3 * b]);
  v3_set(bp, pp[0] + t[0], pp[1] + t[1], pp[2] + t[2]);
  const int j0 = m->body_jnt_start[b], j1 = j0 + m->body_jnt_count[b];
  for (int j = j0; j < j1; ++j) {
    const int qa = m->jnt_qadr[j], da = m->jnt_dadr[j];
    const int type = m->jnt_type[j];
    if (type == J_FREE) {
      v3_set(bp, w.qpos[qa], w.qpos[qa + 1], w.qpos[qa + 2]);
      for (int k = 0; k < 4; ++k) bq[k] = w.qpos[qa + 3 + k];
      q_normalize(bq);
      if (!origin_set) { v3_copy(w.origin, bp); origin_set = 1; }
      float arm[3] = {bp[0] - origin[0], bp[1] - origin[1], bp[2] - origin[2]};
      for (int k = 0; k < 3; ++k) {
        for (int c = 0; c < 6; ++c) w.S[da + k][c] = 0.0f;
        w.S[da + k][3 + k] = 1.0f;
        float e[3] = {0.0f, 0.0f, 0.0f};
        e[k] = 1.0f;
        float ax[3], mom[3];
        q_rotate(ax, bq, e);
        v3_cross(mom, arm, ax);
        float* s = w.S[da + 3 + k];
        s[0] = ax[0]; s[1] = ax[1]; s[2] = ax[2];
        s[3] = mom[0]; s[4] = mom[1]; s[5] = mom[2];
      }
    } else if (type == J_HINGE) {
      const float* axis = &m->jnt_axis[3 * j];
      const float* jpos = &m->jnt_pos[3 * j];
      float half = 0.5f * w.qpos[qa];
      float c = cosf(half), s = sinf(half);
      float ql[4] = {c, s * axis[0], s * axis[1], s * axis[2]};
      float anchor[3];
      q_rotate(t, bq, jpos);
      v3_set(anchor, bp[0] + t[0], bp[1] + t[1], bp[2] + t[2]);
      float nq_[4];
      q_mul(nq_, bq, ql);
      for (int k = 0; k < 4; ++k) bq[k] = nq_[k];
      q_rotate(t, bq, jpos);
      v3_set(bp, anchor[0] - t[0], anchor[1] - t[1], anchor[2] - t[2]);
      float ax[3], arm[3], mom[3];
      q_rotate(ax, bq, axis);
      v3_set(arm, anchor[0] - origin[0], anchor[1] - origin[1], anchor[2] - origin[2]);
      v3_cross(mom, arm, ax);
      float* sr = w.S[da];
      sr[0] = ax[0]; sr[1] = ax[1]; sr[2] = ax[2];
      sr[3] = mom[0]; sr[4] = mom[1]; sr[5] = mom[2];
    } else {  // J_SLIDE
      float ax[3];
      q_rotate(ax, bq, &m->jnt_axis[3 * j]);
      const float d = w.qpos[qa];
      v3_set(bp, bp[0] + ax[0] * d, bp[1] + ax[1] * d, bp[2] + ax[2] * d);
      float* sr = w.S[da];
      sr[0] = 0.0f; sr[1] = 0.0f; sr[2] = 0.0f;
      sr[3] = ax[0]; sr[4] = ax[1]; sr[5] = ax[2];
    }
  }
  if (!origin_set) v3_copy(w.origin, bp);
  v3_copy(w.xpos[b], bp);
  q_normalize(bq);
  for (int k = 0; k < 4; ++k) w.xquat[b][k] = bq[k];
}

// Body frames, world-origin motion subspace S and the origin, by tree level.
DEV void fk(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w, int lane) {
  for (int l = 0; l < m->nlevel[0]; ++l) {
    for (int k = H->lvl_ptr[l] + lane; k < H->lvl_ptr[l + 1]; k += NLANE)
      fk_body(m, w, H->lvl_body[k]);
    SYNC();
  }
}

// Body velocities by level, one lane per (body, component); then the
// spatial inertias, one lane per body.
DEV void velocities_inertias(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w,
                             int lane) {
  for (int l = 0; l < m->nlevel[0]; ++l) {
    const int b0 = H->lvl_ptr[l], cnt = (H->lvl_ptr[l + 1] - b0) * 6;
    for (int t = lane; t < cnt; t += NLANE) {
      const int b = H->lvl_body[b0 + t / 6], c = t % 6;
      const int parent = m->body_parent[b];
      float cur = parent < 0 ? 0.0f : w.cvel[parent][c];
      const int d0 = m->body_dof_start[b], d1 = d0 + m->body_dof_count[b];
      for (int i = d0; i < d1; ++i) cur += w.S[i][c] * w.qvel[i];
      w.cvel[b][c] = cur;
    }
    SYNC();
  }
  for (int b = lane; b < m->nbody[0]; b += NLANE) {
    float R[3][3];
    q_to_mat(R, w.xquat[b]);
    const float* I = &m->body_inertia[9 * b];
    float RI[3][3], Iw[3][3];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        RI[a][c] = R[a][0] * I[0 * 3 + c] + R[a][1] * I[1 * 3 + c] + R[a][2] * I[2 * 3 + c];
    for (int a = 0; a < 3; ++a)
      for (int c = 0; c < 3; ++c)
        Iw[a][c] = RI[a][0] * R[c][0] + RI[a][1] * R[c][1] + RI[a][2] * R[c][2];
    float t[3];
    q_rotate(t, w.xquat[b], &m->body_ipos[3 * b]);
    float c[3] = {w.xpos[b][0] + t[0] - w.origin[0], w.xpos[b][1] + t[1] - w.origin[1],
                  w.xpos[b][2] + t[2] - w.origin[2]};
    const float mass = m->body_mass[b];
    for (int k = 0; k < 3; ++k) w.h[b][k] = c[k] * mass;
    const float cc = v3_dot(c, c);
    for (int a = 0; a < 3; ++a)
      for (int k = 0; k < 3; ++k)
        w.A[b][3 * a + k] = (Iw[a][k] + (a == k ? mass * cc : 0.0f)) - (mass * c[a]) * c[k];
  }
  SYNC();
}

// Body accelerations (velocity products and gravity) by level, one lane per
// body; then f_b = I a + v x* (I v) per body, kept in facc before the
// subtree sums (the first loops of field_physics._rnea_bias).
DEV void accelerations(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w,
                       int lane) {
  for (int l = 0; l < m->nlevel[0]; ++l) {
    for (int k = H->lvl_ptr[l] + lane; k < H->lvl_ptr[l + 1]; k += NLANE) {
      const int b = H->lvl_body[k];
      const int parent = m->body_parent[b];
      float a[6], v_run[6];
      for (int c = 0; c < 6; ++c) {
        a[c] = parent < 0 ? (c < 3 ? 0.0f : -m->gravity[c - 3]) : w.racc[parent][c];
        v_run[c] = parent < 0 ? 0.0f : w.cvel[parent][c];
      }
      const int j0 = m->body_jnt_start[b], j1 = j0 + m->body_jnt_count[b];
      for (int j = j0; j < j1; ++j) {
        const int da = m->jnt_dadr[j];
        float cx[6];
        if (m->jnt_type[j] == J_FREE) {
          float vj[6];
          for (int c = 0; c < 6; ++c)
            vj[c] = (w.S[da + 3][c] * w.qvel[da + 3] + w.S[da + 4][c] * w.qvel[da + 4])
                    + w.S[da + 5][c] * w.qvel[da + 5];
          sp_motion_cross(cx, w.cvel[b], vj);
          for (int c = 0; c < 6; ++c) { a[c] += cx[c]; v_run[c] = w.cvel[b][c]; }
        } else {
          sp_motion_cross(cx, v_run, w.S[da]);
          const float qd = w.qvel[da];
          for (int c = 0; c < 6; ++c) {
            a[c] += cx[c] * qd;
            v_run[c] += w.S[da][c] * qd;
          }
        }
      }
      for (int c = 0; c < 6; ++c) w.racc[b][c] = a[c];
    }
    SYNC();
  }
  for (int b = lane; b < m->nbody[0]; b += NLANE) {
    float Ia[6], Iv[6], t1a[3], t1b[3], t2[3];
    const float mass = m->body_mass[b];
    inertia_mul(Ia, w.A[b], w.h[b], mass, w.racc[b]);
    inertia_mul(Iv, w.A[b], w.h[b], mass, w.cvel[b]);
    v3_cross(t1a, w.cvel[b], Iv);
    v3_cross(t1b, w.cvel[b] + 3, Iv + 3);
    v3_cross(t2, w.cvel[b], Iv + 3);
    for (int k = 0; k < 3; ++k) {
      w.facc[b][k] = Ia[k] + (t1a[k] + t1b[k]);
      w.facc[b][3 + k] = Ia[3 + k] + t2[k];
    }
  }
  SYNC();
}

// ---------------------------------------------------------------------------
// Dynamics (field_physics._crba, _rnea_bias)
// ---------------------------------------------------------------------------

// Leaves to root, one lane per (body, component): the composite inertias
// (A, h) and the subtree sums of f_b, children added in descending index as
// the serial loops `for b = nb-1..0: v[parent(b)] += v[b]` add them.
DEV void bodies_up(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w, int lane) {
  for (int l = m->nlevel[0] - 1; l >= 0; --l) {
    const int b0 = H->lvl_ptr[l], cnt = (H->lvl_ptr[l + 1] - b0) * 18;
    for (int t = lane; t < cnt; t += NLANE) {
      const int b = H->lvl_body[b0 + t / 18], c = t % 18;
      const int k0 = H->child_ptr[b], k1 = H->child_ptr[b + 1];
      if (c < 12) {
        float acc = c < 9 ? w.A[b][c] : w.h[b][c - 9];
        for (int k = k0; k < k1; ++k) acc += w.cAh[H->child[k]][c];
        w.cAh[b][c] = acc;
      } else {
        float acc = w.facc[b][c - 12];
        for (int k = k0; k < k1; ++k) acc += w.facc[H->child[k]][c - 12];
        w.facc[b][c - 12] = acc;
      }
    }
    SYNC();
  }
}

// Mass matrix on the ancestor pairs (plus armature on the diagonal), into
// L.x as it is and into L.y with the implicit diagonal h*damping (+ h*kd),
// and the bias force per dof.
DEV void mass_matrix_bias(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w,
                          int lane) {
  const int nv = m->nv[0], npair = m->npair[0];
  for (int i = lane; i < nv; i += NLANE) {
    const int bi = H->dof_body[i];
    inertia_mul(w.F[i], w.cAh[bi], w.cAh[bi] + 9, m->body_subtree_mass[bi], w.S[i]);
    w.bias[i] = sp_dot(w.S[i], w.facc[bi]);
  }
  SYNC();
  for (int p = lane; p < npair; p += NLANE) {
    const int i = H->pair_i[p], j = H->pair_j[p];
    float v = sp_dot(w.S[j], w.F[i]);
    w.L[p].x = w.L[p].y = v;
    if (i == j) {
      v += m->dof_armature[i];
      w.L[p].x = v;
      w.mdiag[i] = v;
      w.L[p].y = v + m->dof_extra_diag[i];
    }
  }
  SYNC();
}

// ---------------------------------------------------------------------------
// Leaves-first tree Cholesky (field_physics._factor/_solve).  L(k, i) for an
// ancestor i of dof k lives at its pair index; invd[k] = 1 / L(k, k).
// ---------------------------------------------------------------------------

// Both factors at once, by body level from the leaves up.  Entry (k, i)
// takes the terms L(c, i) L(c, k) of its dofs' descendants c in descending
// order, as the serial right-looking program (steps c = nv-1 .. 0) subtracts
// them: first those of descendant bodies (done at deeper levels; parallel
// over entries), then those of its own body's later dofs (right-looking
// steps inside the bodies of the level, which scale column k on the fly).
// The level's columns are scaled by 1 / L(k, k) last; the diagonal itself is
// kept only as invd.
DEV void factor(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w, int lane) {
  for (int l = m->nlevel[0] - 1; l >= 0; --l) {
    const int e0 = H->fa_ptr[l], e1 = H->fa_ptr[l + 1];
    for (int e = e0 + lane; e < e1; e += NLANE) {
      const int p = H->fa_ent[e] & 1023;
      Pair acc = w.L[p];
      for (int o = H->fa_op_ptr[e]; o < H->fa_op_ptr[e + 1]; ++o) {
        const int op = H->fa_op[o];
        const Pair a = w.L[op & 1023], b = w.L[op >> 10];
        acc.x -= a.x * b.x;
        acc.y -= a.y * b.y;
      }
      w.L[p] = acc;
    }
    SYNC();
    for (int st = H->fl_step_ptr[l]; st < H->fl_step_ptr[l + 1]; ++st) {
      for (int t = H->fb_piv_ptr[st] + lane; t < H->fb_piv_ptr[st + 1]; t += NLANE) {
        const int piv = H->fb_piv[t], k = piv & 255;
        const Pair d = w.L[piv >> 8];
        w.invd0[k] = 1.0f / sqrtf(fmaxf(d.x, 1e-12f));
        w.invd1[k] = 1.0f / sqrtf(fmaxf(d.y, 1e-12f));
      }
      SYNC();
      for (int t = H->fb_upd_ptr[st] + lane; t < H->fb_upd_ptr[st + 1]; t += NLANE) {
        const int code = H->fb_upd[t], pa = (code >> 10) & 1023, k = H->pair_i[pa];
        const float inv0 = w.invd0[k], inv1 = w.invd1[k];
        const Pair a = w.L[pa], b = w.L[code >> 20];
        const float la0 = a.x * inv0, lb0 = b.x * inv0;
        const float la1 = a.y * inv1, lb1 = b.y * inv1;
        Pair& tg = w.L[code & 1023];
        tg.x -= lb0 * la0;
        tg.y -= lb1 * la1;
      }
      SYNC();
    }
    for (int e = e0 + lane; e < e1; e += NLANE) {
      const int ent = H->fa_ent[e], k = (ent >> 10) & 63;
      if (!(ent >> 16)) {
        w.L[ent & 1023].x *= w.invd0[k];
        w.L[ent & 1023].y *= w.invd1[k];
      }
    }
    SYNC();
  }
}

// Solve (L L^T) x = rhs in place (x returned in rhs): the forward sweep
// pushes each y_j into its ancestors (leaves first), the backward sweep pulls
// each dof's ancestors, one tree depth at a time.
DEV void solve(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w, float* rhs,
               int lane) {
  for (int j = m->nv[0] - 1; j >= 0; --j) {
    const float yj = rhs[j] * w.invd1[j];
    if (lane == 0) w.y[j] = yj;
    for (int a = H->anc_ptr[j] + lane; a < H->anc_ptr[j + 1]; a += NLANE)
      rhs[H->anc_dof[a]] -= w.L[H->anc_pair[a]].y * yj;
    SYNC();
  }
  for (int d = 0; d < m->ndepth[0]; ++d) {
    for (int t = H->dep_ptr[d] + lane; t < H->dep_ptr[d + 1]; t += NLANE) {
      const int i = H->dep_dof[t];
      float acc = w.y[i];
      for (int a = H->anc_ptr[i]; a < H->anc_ptr[i + 1]; ++a)
        acc -= w.L[H->anc_pair[a]].y * rhs[H->anc_dof[a]];
      rhs[i] = acc * w.invd1[i];
    }
    SYNC();
  }
}

// ---------------------------------------------------------------------------
// Contacts (field_physics._contact_geometry, _delassus_inv_mass,
// _contact_forces)
// ---------------------------------------------------------------------------

DEV void capsule_end(float* o, const float* p, const float* q, float hh, float sign) {
  const float z[3] = {0.0f, 0.0f, 1.0f};
  float ax[3];
  q_rotate(ax, q, z);
  if (sign < 0.0f) v3_set(o, p[0] - ax[0] * hh, p[1] - ax[1] * hh, p[2] - ax[2] * hh);
  else v3_set(o, p[0] + ax[0] * hh, p[1] + ax[1] * hh, p[2] + ax[2] * hh);
}

DEV void closest_on_segment(float* o, const float* a, const float* b, const float* p) {
  float ab[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  float ap[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
  float t = v3_dot(ap, ab) / fmaxf(v3_dot(ab, ab), 1e-12f);
  t = fminf(fmaxf(t, 0.0f), 1.0f);
  v3_set(o, a[0] + ab[0] * t, a[1] + ab[1] * t, a[2] + ab[2] * t);
}

// Closest point, normal and signed distance of point pl (box frame) vs a box.
DEV void point_box(const float* pl, const float* half, float* closest, float* n, float* dist) {
  const float hx = half[0], hy = half[1], hz = half[2];
  float cl[3] = {fminf(fmaxf(pl[0], -hx), hx), fminf(fmaxf(pl[1], -hy), hy),
                 fminf(fmaxf(pl[2], -hz), hz)};
  float delta[3] = {pl[0] - cl[0], pl[1] - cl[1], pl[2] - cl[2]};
  const float dsq = v3_dot(delta, delta);
  const int outside = dsq > 1e-18f;
  const float d_out = sqrtf(fmaxf(dsq, 1e-18f));
  const float inv = 1.0f / d_out;
  const float gx = hx - fabsf(pl[0]), gy = hy - fabsf(pl[1]), gz = hz - fabsf(pl[2]);
  const float gap_in = fminf(fminf(gx, gy), gz);
  const float sx = pl[0] >= 0.0f ? 1.0f : -1.0f;
  const float sy = pl[1] >= 0.0f ? 1.0f : -1.0f;
  const float sz = pl[2] >= 0.0f ? 1.0f : -1.0f;
  const int is_x = gx <= fminf(gy, gz);
  const int is_y = !is_x && (gy <= gz);
  const int is_z = !is_x && !is_y;
  float n_in[3] = {is_x ? sx : 0.0f, is_y ? sy : 0.0f, is_z ? sz : 0.0f};
  for (int k = 0; k < 3; ++k) {
    n[k] = outside ? delta[k] * inv : n_in[k];
    closest[k] = outside ? cl[k] : pl[k] + n_in[k] * gap_in;
  }
  *dist = outside ? d_out : -gap_in;
}

DEV void sphere_sphere(const float* c1, float r1, const float* c2, float r2,
                       float* dist, float* pos, float* n) {
  float d[3] = {c2[0] - c1[0], c2[1] - c1[1], c2[2] - c1[2]};
  const float ln = sqrtf(fmaxf(v3_dot(d, d), 1e-18f));
  const float inv = 1.0f / ln;
  v3_set(n, d[0] * inv, d[1] * inv, d[2] * inv);
  *dist = ln - (r1 + r2);
  const float s = r1 + 0.5f * *dist;
  v3_set(pos, c1[0] + n[0] * s, c1[1] + n[1] * s, c1[2] + n[2] * s);
}

// dist, contact point and normal (1 -> 2) of slot si.
DEV void slot_geometry(const Model* __restrict__ m, const Work& w, int si,
                       float* dist, float* pos, float* n) {
  const int kind = m->slot_kind[si];
  const int g1 = m->slot_g1[si], g2 = m->slot_g2[si];
  const float* s1 = &m->geom_size[3 * g1];
  const float* s2 = &m->geom_size[3 * g2];
  const float* p1 = w.gpos[g1];
  const float* q1 = w.gquat[g1];
  const float* p2 = w.gpos[g2];
  const float* q2 = w.gquat[g2];
  const float* ex = &m->slot_extra[3 * si];
  if (kind <= K_PLANE_CORNER) {
    float pt[3];
    float r = 0.0f;
    if (kind == K_PLANE_SPHERE) {
      v3_copy(pt, p2);
      r = s2[0];
    } else if (kind == K_PLANE_CAPEND) {
      capsule_end(pt, p2, q2, s2[1], ex[0]);
      r = s2[0];
    } else {
      float cl[3] = {s2[0] * ex[0], s2[1] * ex[1], s2[2] * ex[2]};
      float t[3];
      q_rotate(t, q2, cl);
      v3_set(pt, p2[0] + t[0], p2[1] + t[1], p2[2] + t[2]);
    }
    float hgt;
    if (m->slot_static[si]) {
      v3_copy(n, &m->slot_frame[9 * si]);
      hgt = v3_dot(n, pt) - m->slot_d0[si];
    } else {
      const float z[3] = {0.0f, 0.0f, 1.0f};
      q_rotate(n, q1, z);
      float rel[3] = {pt[0] - p1[0], pt[1] - p1[1], pt[2] - p1[2]};
      hgt = v3_dot(n, rel);
    }
    *dist = hgt - r;
    const float s = r + 0.5f * *dist;
    v3_set(pos, pt[0] - n[0] * s, pt[1] - n[1] * s, pt[2] - n[2] * s);
    return;
  }
  if (kind == K_SPHERE_SPHERE) {
    sphere_sphere(p1, s1[0], p2, s2[0], dist, pos, n);
    return;
  }
  if (kind == K_SPHERE_CAPSULE) {
    float e0[3], e1[3], cp[3];
    capsule_end(e0, p2, q2, s2[1], -1.0f);
    capsule_end(e1, p2, q2, s2[1], 1.0f);
    closest_on_segment(cp, e0, e1, p1);
    sphere_sphere(p1, s1[0], cp, s2[0], dist, pos, n);
    return;
  }
  if (kind == K_BOXCORNER_BOX || kind == K_BOX_BOXCORNER) {
    // one corner of box a probed against box b
    const int a_first = kind == K_BOXCORNER_BOX;
    const float* pa = a_first ? p1 : p2;
    const float* qa = a_first ? q1 : q2;
    const float* sa = a_first ? s1 : s2;
    const float* pb = a_first ? p2 : p1;
    const float* qb = a_first ? q2 : q1;
    const float* sb = a_first ? s2 : s1;
    float ra[3][3], rb[3][3];
    q_to_mat(ra, qa);
    q_to_mat(rb, qb);
    const float cl[3] = {sa[0] * ex[0], sa[1] * ex[1], sa[2] * ex[2]};
    float rel[3], pl[3];
    for (int i = 0; i < 3; ++i)
      rel[i] = (pa[i] + ra[i][0] * cl[0] + ra[i][1] * cl[1] + ra[i][2] * cl[2]) - pb[i];
    for (int i = 0; i < 3; ++i) pl[i] = rb[0][i] * rel[0] + rb[1][i] * rel[1] + rb[2][i] * rel[2];
    float closest[3], nl[3], d;
    point_box(pl, sb, closest, nl, &d);
    float nw[3];
    for (int i = 0; i < 3; ++i) {
      nw[i] = v3_dot(rb[i], nl);
      pos[i] = (pb[i] + v3_dot(rb[i], closest)) + nw[i] * (0.5f * d);
      n[i] = a_first ? -nw[i] : nw[i];
    }
    *dist = d;
    return;
  }
  if (kind == K_SPHERE_BOX) {
    float rel[3] = {p1[0] - p2[0], p1[1] - p2[1], p1[2] - p2[2]};
    float pl[3], closest[3], nl[3], d, t[3];
    q_rotate_inv(pl, q2, rel);
    point_box(pl, s2, closest, nl, &d);
    *dist = d - s1[0];
    q_rotate(t, q2, nl);
    v3_set(n, -t[0], -t[1], -t[2]);
    q_rotate(t, q2, closest);
    const float s = 0.5f * *dist;
    v3_set(pos, (p2[0] + t[0]) - n[0] * s, (p2[1] + t[1]) - n[1] * s, (p2[2] + t[2]) - n[2] * s);
    return;
  }
  if (kind == K_CAPSULE_CAPSULE) {
    float a0[3], a1[3], b0[3], b1[3];
    capsule_end(a0, p1, q1, s1[1], -1.0f);
    capsule_end(a1, p1, q1, s1[1], 1.0f);
    capsule_end(b0, p2, q2, s2[1], -1.0f);
    capsule_end(b1, p2, q2, s2[1], 1.0f);
    float d1[3] = {a1[0] - a0[0], a1[1] - a0[1], a1[2] - a0[2]};
    float d2[3] = {b1[0] - b0[0], b1[1] - b0[1], b1[2] - b0[2]};
    float r[3] = {a0[0] - b0[0], a0[1] - b0[1], a0[2] - b0[2]};
    const float a = v3_dot(d1, d1), e = v3_dot(d2, d2), fq = v3_dot(d2, r);
    const float c = v3_dot(d1, r), b = v3_dot(d1, d2);
    const float denom = a * e - b * b;
    float s = denom > 1e-12f ? (b * fq - c * e) / fmaxf(denom, 1e-12f) : 0.0f;
    s = fminf(fmaxf(s, 0.0f), 1.0f);
    float t = (b * s + fq) / fmaxf(e, 1e-12f);
    t = fminf(fmaxf(t, 0.0f), 1.0f);
    s = fminf(fmaxf((b * t - c) / fmaxf(a, 1e-12f), 0.0f), 1.0f);
    float cp1[3] = {a0[0] + d1[0] * s, a0[1] + d1[1] * s, a0[2] + d1[2] * s};
    float cp2[3] = {b0[0] + d2[0] * t, b0[1] + d2[1] * t, b0[2] + d2[2] * t};
    sphere_sphere(cp1, s1[0], cp2, s2[0], dist, pos, n);
    return;
  }
  // K_CAPSULE_BOX
  float a0[3], a1[3], cp[3], rel[3], pl[3], closest[3], nl[3], d, t[3], box_pt[3];
  capsule_end(a0, p1, q1, s1[1], -1.0f);
  capsule_end(a1, p1, q1, s1[1], 1.0f);
  closest_on_segment(cp, a0, a1, p2);
  v3_set(rel, cp[0] - p2[0], cp[1] - p2[1], cp[2] - p2[2]);
  q_rotate_inv(pl, q2, rel);
  point_box(pl, s2, closest, nl, &d);
  q_rotate(t, q2, closest);
  v3_set(box_pt, p2[0] + t[0], p2[1] + t[1], p2[2] + t[2]);
  closest_on_segment(cp, a0, a1, box_pt);
  v3_set(rel, cp[0] - p2[0], cp[1] - p2[1], cp[2] - p2[2]);
  q_rotate_inv(pl, q2, rel);
  point_box(pl, s2, closest, nl, &d);
  *dist = d - s1[0];
  q_rotate(t, q2, nl);
  v3_set(n, -t[0], -t[1], -t[2]);
  q_rotate(t, q2, closest);
  const float s = 0.5f * *dist;
  v3_set(pos, (p2[0] + t[0]) - n[0] * s, (p2[1] + t[1]) - n[1] * s, (p2[2] + t[2]) - n[2] * s);
}

// w = ||L^-1 J^T||^2 over the union of the two bodies' ancestor chains, for a
// unit spatial force f_hat about the origin (J = +S.f on body2's chain, -S.f
// on body1's, 0 on the shared root path).  Uses the plain-M factor, w.L.x.
// The elimination runs in this lane's scratch column, indexed by position
// in the slot's support; y_j replaces acc_j once dof j is eliminated.
DEV float delassus_inv_mass(const Hot* __restrict__ H, Work& w, int si, const float* f_hat,
                            int lane) {
  float* acc = &w.lane_acc[0][lane];
  const unsigned char* pos = (const unsigned char*)H->dl_pos;
  const int s0 = H->slot_supp_start[si], n = H->slot_supp_count[si];
  for (int s = 0; s < n; ++s) {
    const int i = H->supp_dof[s0 + s];
    const int sg = H->supp_sign[s0 + s];
    acc[s * NLANE] = sg == 0 ? 0.0f : (sg > 0 ? sp_dot(w.S[i], f_hat) : -sp_dot(w.S[i], f_hat));
  }
  // supp is ascending; eliminate distal dofs first (push form)
  int off = H->slot_dl_end[si];
  for (int s = n - 1; s >= 0; --s) {
    const int j = H->supp_dof[s0 + s];
    const float yj = acc[s * NLANE] * w.invd0[j];
    acc[s * NLANE] = yj;
    const int a0 = H->anc_ptr[j], na = H->anc_ptr[j + 1] - a0;
    off -= na;
    for (int x = 0; x < na; ++x)
      acc[pos[off + x] * NLANE] -= w.L[H->anc_pair[a0 + x]].x * yj;
  }
  float sum = 0.0f;
  for (int s = 0; s < n; ++s) {
    const float yi = acc[s * NLANE];
    sum += yi * yi;
  }
  return sum;
}

// World poses of all geoms for this substep.
DEV void geom_poses(const Model* __restrict__ m, Work& w, int lane) {
  for (int g = lane; g < m->ngeom[0]; g += NLANE) {
    const int b = m->geom_body[g];
    const float* gp = &m->geom_pos[3 * g];
    const float* gq = &m->geom_quat[4 * g];
    if (b < 0) {
      v3_copy(w.gpos[g], gp);
      for (int k = 0; k < 4; ++k) w.gquat[g][k] = gq[k];
    } else {
      float t[3];
      q_rotate(t, w.xquat[b], gp);
      v3_set(w.gpos[g], w.xpos[b][0] + t[0], w.xpos[b][1] + t[1], w.xpos[b][2] + t[2]);
      q_mul(w.gquat[g], w.xquat[b], gq);
    }
  }
  SYNC();
}

// Contact forces into w.facc (per-body spatial force about the origin, each
// body summing its slots in slot order); returns the fall flag.  entry = 1 at
// the policy step's first substep (solves and holds the self-contact masses
// in 'step' mode).
DEV float contact_forces(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w, int entry,
                         int lane) {
  geom_poses(m, w, lane);
  float fall = 0.0f;
  const float kstiff = m->kstiff[0], bdamp = m->bdamp[0], fric_gain = m->fric_gain[0];
  const int smode = m->self_mass[0];
  for (int r = lane; r < m->nslot_order[0]; r += NLANE) {
    const int si = H->slot_order[r];
    if (si < 0) continue;
    float dist, pos[3], n[3];
    slot_geometry(m, w, si, &dist, pos, n);
    const int b1 = m->slot_b1[si], b2 = m->slot_b2[si];
    const int ground = b1 < 0;
    const int is_plane = m->slot_kind[si] <= K_PLANE_CORNER;
    const int with_friction = is_plane || m->self_friction[0];
    float t1[3], t2[3];
    if (m->slot_static[si]) {
      v3_copy(t1, &m->slot_frame[9 * si + 3]);
      v3_copy(t2, &m->slot_frame[9 * si + 6]);
    } else if (with_friction) {
      const int use_x = fabsf(n[0]) < 0.5f;
      float ref[3] = {use_x ? 1.0f : 0.0f, use_x ? 0.0f : 1.0f, 0.0f};
      v3_cross(t1, n, ref);
      const float inv = RSQRT(fmaxf(v3_dot(t1, t1), 1e-12f));
      v3_set(t1, t1[0] * inv, t1[1] * inv, t1[2] * inv);
      v3_cross(t2, n, t1);
    }
    float arm[3] = {pos[0] - w.origin[0], pos[1] - w.origin[1], pos[2] - w.origin[2]};
    float vrel[3] = {0.0f, 0.0f, 0.0f};
    if (b2 >= 0) {
      float t[3];
      v3_cross(t, w.cvel[b2], arm);
      for (int k = 0; k < 3; ++k) vrel[k] += w.cvel[b2][3 + k] + t[k];
    }
    if (b1 >= 0) {
      float t[3];
      v3_cross(t, w.cvel[b1], arm);
      for (int k = 0; k < 3; ++k) vrel[k] -= w.cvel[b1][3 + k] + t[k];
    }
    const float vn = v3_dot(n, vrel);

    // A contact that is not active pushes with zero force whatever its mass
    // (fn = 0 and the friction cone is 0), so only active ones need the
    // Delassus solve, and the held 'step' masses at the entry substep.
    const int active = dist < 0.0f;
    float m_eff;
    if ((active && (ground || smode == SELF_SUBSTEP)) || (!ground && smode == SELF_STEP && entry)) {
      float f_hat[6];
      v3_cross(f_hat, arm, n);
      f_hat[3] = n[0]; f_hat[4] = n[1]; f_hat[5] = n[2];
      m_eff = 1.0f / fmaxf(delassus_inv_mass(H, w, si, f_hat, lane), 1e-6f);
      if (!ground && smode == SELF_STEP) w.held[si] = m_eff;
    } else if (!ground && smode == SELF_STEP) {
      m_eff = w.held[si];
    } else {
      m_eff = m->slot_meff[si];
    }

    const float pen = fminf(dist, 0.0f);
    float fn = m_eff * (-kstiff * pen - bdamp * vn);
    fn = active ? fmaxf(fn, 0.0f) : 0.0f;
    float fw[3];
    if (with_friction) {
      const float ft_scale = -m_eff * fric_gain;
      const float f1r = ft_scale * v3_dot(t1, vrel), f2r = ft_scale * v3_dot(t2, vrel);
      const float ft_norm = sqrtf(fmaxf(f1r * f1r + f2r * f2r, 1e-18f));
      const float cone = m->slot_friction[si] * fn;
      const float scale = ft_norm > 1e-9f ? fminf(1.0f, cone / ft_norm) : 0.0f;
      const float f1 = f1r * scale, f2 = f2r * scale;
      for (int k = 0; k < 3; ++k) fw[k] = (n[k] * fn + t1[k] * f1) + t2[k] * f2;
    } else {
      for (int k = 0; k < 3; ++k) fw[k] = n[k] * fn;
    }
    v3_cross(w.sf[si], arm, fw);
    v3_copy(w.sf[si] + 3, fw);
    if (m->slot_fall[si] && active) fall = 1.0f;
  }
  fall = warp_max(fall);
  SYNC();
  for (int b = lane; b < m->nbody[0]; b += NLANE) {
    float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    for (int k = H->body_slot_ptr[b]; k < H->body_slot_ptr[b + 1]; ++k) {
      const int e = H->body_slot[k];
      const float* f = w.sf[e >> 1];
      for (int c = 0; c < 6; ++c) acc[c] = (e & 1) ? acc[c] - f[c] : acc[c] + f[c];
    }
    for (int c = 0; c < 6; ++c) w.facc[b][c] = acc[c];
  }
  SYNC();
  return fall;
}

// ---------------------------------------------------------------------------
// One substep (field_physics.substep) and one policy step
// ---------------------------------------------------------------------------

DEV float substep(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w, int entry,
                  int lane) {
  const int nv = m->nv[0];
  const float h = m->dt[0];
  fk(m, H, w, lane);
  velocities_inertias(m, H, w, lane);
  accelerations(m, H, w, lane);
  bodies_up(m, H, w, lane);
  mass_matrix_bias(m, H, w, lane);
  factor(m, H, w, lane);  // M for the Delassus masses, M + diag for the solve
  const float fall = contact_forces(m, H, w, entry, lane);
  force_subtree_sums(m, H, w, lane);

  // per dof: constraint force, joint limit (M diagonal as effective mass),
  // bias and damping, actuator (the right-hand side, then qacc, in qfrc)
  const float lk = m->lk[0], lb = m->lb[0];
  const int pd = m->mode[0] == MODE_PD;
  for (int i = lane; i < nv; i += NLANE) {
    float f = sp_dot(w.S[i], w.facc[H->dof_body[i]]);
    const int l = H->dof_lim[i];
    if (l >= 0) {
      const float q = w.qpos[m->lim_qadr[l]], qd = w.qvel[i];
      const float me = w.mdiag[i];
      const float over_hi = fmaxf(q - m->lim_hi[l], 0.0f);
      const float over_lo = fmaxf(m->lim_lo[l] - q, 0.0f);
      const float tau_hi = fminf(over_hi > 0.0f ? me * (-lk * over_hi - lb * qd) : 0.0f, 0.0f);
      const float tau_lo = fmaxf(over_lo > 0.0f ? me * (lk * over_lo - lb * qd) : 0.0f, 0.0f);
      f += tau_hi + tau_lo;
    }
    f = (-w.bias[i] - m->dof_damping[i] * w.qvel[i]) + f;
    const int a = H->dof_act[i];
    if (a >= 0) {
      float tau;
      if (pd) {
        const float e = (w.qpos[m->act_qadr[a]] + h * w.qvel[i]) - w.u[a];
        tau = -m->act_kp[a] * e - m->act_kd[a] * w.qvel[i];
      } else {
        tau = w.u[a];
      }
      f += fminf(fmaxf(tau, m->act_lo[a]), m->act_hi[a]);
    }
    w.qfrc[i] = f;
  }
  SYNC();
  solve(m, H, w, w.qfrc, lane);

  // semi-implicit Euler with the defensive qvel clamp
  for (int i = lane; i < nv; i += NLANE)
    w.qvel[i] = fminf(fmaxf(w.qvel[i] + h * w.qfrc[i], -1e3f), 1e3f);
  SYNC();
  for (int j = lane; j < m->njnt[0]; j += NLANE) {
    const int qa = m->jnt_qadr[j], da = m->jnt_dadr[j];
    if (m->jnt_type[j] == J_FREE) {
      for (int k = 0; k < 3; ++k) w.qpos[qa + k] += h * w.qvel[da + k];
      // q * exp(omega h), stable at small angles
      const float* om = &w.qvel[da + 3];
      const float a2 = v3_dot(om, om) * (h * h);
      const float angle = sqrtf(fmaxf(a2, 1e-24f));
      const float half = 0.5f * angle;
      const float k = a2 < 1e-14f ? 0.5f * h - a2 * h / 48.0f : sinf(half) / angle * h;
      const float dq[4] = {cosf(half), om[0] * k, om[1] * k, om[2] * k};
      float q[4] = {w.qpos[qa + 3], w.qpos[qa + 4], w.qpos[qa + 5], w.qpos[qa + 6]};
      float qn[4];
      q_mul(qn, q, dq);
      q_normalize(qn);
      for (int k2 = 0; k2 < 4; ++k2) w.qpos[qa + 3 + k2] = qn[k2];
    } else {
      w.qpos[qa] += h * w.qvel[da];
    }
  }
  SYNC();
  return fall;
}

// One env's policy step.  Arrays are row-major (B, K): env's row at env * K.
DEV void policy_step(const Model* __restrict__ m, const Hot* __restrict__ H, Work& w, int env,
                     int lane, const float* __restrict__ qpos_in, const float* __restrict__ qvel_in,
                     const float* __restrict__ u_in, float* __restrict__ qpos_out,
                     float* __restrict__ qvel_out, float* __restrict__ xpos_out,
                     float* __restrict__ xquat_out, float* __restrict__ fall_out) {
  const int nq = m->nq[0], nv = m->nv[0], nu = m->nu[0], nb = m->nbody[0];
  const int ku = nu > 0 ? nu : 1;  // a model without actuators gets one column
  const size_t e = (size_t)env;
  for (int i = lane; i < nq; i += NLANE) w.qpos[i] = qpos_in[e * nq + i];
  for (int i = lane; i < nv; i += NLANE) w.qvel[i] = qvel_in[e * nv + i];
  for (int a = lane; a < nu; a += NLANE) w.u[a] = u_in[e * ku + a];
  SYNC();
  float fall = 0.0f;
  const int n = m->n_substeps[0];
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int s = 0; s < n; ++s) fall = fmaxf(fall, substep(m, H, w, s == 0, lane));
  fk(m, H, w, lane);
  for (int i = lane; i < nq; i += NLANE) qpos_out[e * nq + i] = w.qpos[i];
  for (int i = lane; i < nv; i += NLANE) qvel_out[e * nv + i] = w.qvel[i];
  for (int t = lane; t < 3 * nb; t += NLANE) xpos_out[e * 3 * nb + t] = w.xpos[t / 3][t % 3];
  for (int t = lane; t < 4 * nb; t += NLANE) xquat_out[e * 4 * nb + t] = w.xquat[t / 4][t % 4];
  if (lane == 0) fall_out[env] = fall;
}

// ---------------------------------------------------------------------------
// Entry points (plain C interface, bound with ctypes)
// ---------------------------------------------------------------------------

#define FIELD_NAME(t, n, c) #n ","
#define FIELD_OFFSET(t, n, c) (int)(offsetof(Model, n) / 4),
#define HOT_OFFSET(t, n, c) (int)((offsetof(Model, hot) + offsetof(Hot, n)) / 4),

extern "C" int mimic_model_words() { return (int)(sizeof(Model) / 4); }

extern "C" const char* mimic_model_names() {
  return MODEL_FIELDS(FIELD_NAME) HOT_FIELDS(FIELD_NAME);
}

// Writes the word offset of every MODEL_FIELDS and HOT_FIELDS entry; returns
// their count.
extern "C" int mimic_model_offsets(int* out, int cap) {
  static const int offs[] = {MODEL_FIELDS(FIELD_OFFSET) HOT_FIELDS(HOT_OFFSET)};
  const int n = (int)(sizeof(offs) / sizeof(offs[0]));
  for (int i = 0; i < n && i < cap; ++i) out[i] = offs[i];
  return n;
}

#ifdef __CUDACC__

#define MAX_WARPS 12  // warps (envs) of a block at most: 13 and 9-11 were slower
constexpr int kHotBytes = (int)((sizeof(Hot) + 15) / 16 * 16);

// A persistent grid: each block stages the hot index lists into shared
// memory once, then each warp walks its envs; a ragged tail of B leaves
// whole warps without an env.
__global__ void __launch_bounds__(32 * MAX_WARPS, 1)
mimic_step_kernel(const Model* __restrict__ m, int B, const float* __restrict__ qpos_in,
                  const float* __restrict__ qvel_in, const float* __restrict__ u_in,
                  float* __restrict__ qpos_out, float* __restrict__ qvel_out,
                  float* __restrict__ xpos_out, float* __restrict__ xquat_out,
                  float* __restrict__ fall_out) {
  extern __shared__ float4 smem[];
  const int* src = reinterpret_cast<const int*>(&m->hot);
  int* dst = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < (int)(sizeof(Hot) / 4); i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  const Hot* H = reinterpret_cast<const Hot*>(smem);
  const int warps = blockDim.x / NLANE, warp = threadIdx.x / NLANE, lane = threadIdx.x % NLANE;
  Work& w = reinterpret_cast<Work*>(reinterpret_cast<char*>(smem) + kHotBytes)[warp];
  for (int env = blockIdx.x * warps + warp; env < B; env += gridDim.x * warps)
    policy_step(m, H, w, env, lane, qpos_in, qvel_in, u_in, qpos_out, qvel_out, xpos_out,
                xquat_out, fall_out);
}

// The widest block that shared memory allows (at most MAX_WARPS warps) on
// the current device, and how many of them an SM holds.  Worked out once per
// device (the attribute is per device), at its first launch or occupancy
// query, so that a launch inside a CUDA graph's capture makes no other call.
struct Shape {
  int warps, smem, sms, blocks_per_sm;
};

static const int kMaxDevices = 64;
static Shape g_shape[kMaxDevices];
static std::atomic<bool> g_shape_known[kMaxDevices];

static cudaError_t launch_shape(Shape* out) {
  int dev = 0, optin = 0, sms = 0, bps = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && g_shape_known[dev].load(std::memory_order_acquire)) {
    *out = g_shape[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int warps = (optin - kHotBytes) / (int)sizeof(Work);
  if (warps > MAX_WARPS) warps = MAX_WARPS;
  if (warps < 1) return cudaErrorInvalidConfiguration;
  const int smem = kHotBytes + warps * (int)sizeof(Work);
  e = cudaFuncSetAttribute(mimic_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&bps, mimic_step_kernel, 32 * warps, smem);
  if (e != cudaSuccess) return e;
  *out = {warps, smem, sms, bps};
  if (cached) {
    g_shape[dev] = *out;
    g_shape_known[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// Launches one policy step for B envs on `stream` on the current device: at
// most one block per SM, each as wide as B / SMs envs needs and shared memory
// allows; returns the launch's cudaError_t.
extern "C" int mimic_step_launch(const void* model, int B, const float* qpos_in,
                                 const float* qvel_in, const float* u_in, float* qpos_out,
                                 float* qvel_out, float* xpos_out, float* xquat_out,
                                 float* fall_out, void* stream) {
  Shape sh;
  cudaError_t e = launch_shape(&sh);
  if (e != cudaSuccess) return (int)e;
  int warps = (B + sh.sms - 1) / sh.sms;
  if (warps > sh.warps) warps = sh.warps;
  int blocks = (B + warps - 1) / warps;
  if (blocks > sh.sms * sh.blocks_per_sm) blocks = sh.sms * sh.blocks_per_sm;
  const int smem = kHotBytes + warps * (int)sizeof(Work);
  mimic_step_kernel<<<blocks, 32 * warps, smem, (cudaStream_t)stream>>>(
      (const Model*)model, B, qpos_in, qvel_in, u_in, qpos_out, qvel_out, xpos_out,
      xquat_out, fall_out);
  return (int)cudaGetLastError();
}

// The widest block and its occupancy on the current device: out = {resident
// blocks per SM, threads per block, dynamic shared bytes per block, envs per
// block, lanes per env, staged table bytes}; returns a cudaError_t.
extern "C" int mimic_step_occupancy(int* out) {
  Shape sh;
  cudaError_t e = launch_shape(&sh);
  if (e != cudaSuccess) return (int)e;
  out[0] = sh.blocks_per_sm; out[1] = 32 * sh.warps; out[2] = sh.smem;
  out[3] = sh.warps; out[4] = NLANE; out[5] = kHotBytes;
  return 0;
}

#else  // host build of the same device code (one lane), for the CPU tests

extern "C" int mimic_step_host(const void* model, int B, const float* qpos_in,
                               const float* qvel_in, const float* u_in, float* qpos_out,
                               float* qvel_out, float* xpos_out, float* xquat_out,
                               float* fall_out) {
  static Work w;
  const Model* m = (const Model*)model;
  for (int env = 0; env < B; ++env)
    policy_step(m, &m->hot, w, env, 0, qpos_in, qvel_in, u_in, qpos_out, qvel_out, xpos_out,
                xquat_out, fall_out);
  return 0;
}

#endif
