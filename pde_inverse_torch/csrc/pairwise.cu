// K5-K8: the pairwise mean-field sums of the non-parametric KMV loss for a
// PotentialMLP interaction kernel, forward and VJP, for Hopper.
//
// For each stamp t, point i and ref j the pair's first-layer preactivation
// is z0 = ax[t, i] - ar[t, j], with the velocity tangent d_v z0 = av[t, i].
// The forward kernel sums over the refs j, weighted by mask[j]:
//     value[t, i] = sum_j mask_j Phi,  hess[t, i] = sum_j mask_j v^T Hess Phi v,
//     s_dz0[t, i] = sum_j mask_j dPhi/dz0.
// The backward kernel is its VJP with respect to the layers, ax, av and ar
// for the cotangents (g_val, g_hess [nt, n], g_dz0 [nt, n, w0]).
//
// Two heads:
// * the square head (K5 forward k5_kernel, or pw_fwd_kernel where a width
//   before the feature layer exceeds 32; K6 backward k6_kernel, or
//   pw_bwd_kernel where one exceeds 64 or k6_kernel's plan does not fit)
//   replaces
//   pde_inverse_tpu/ops/pallas/pairwise_kernel.py::_kernel and ::_bwd_kernel:
//   the layers end with the feature layer and Phi = |z_L|^2;
// * the collapsed head (K7 forward, K8 backward) replaces
//   pairwise_packed.py::_fwd_kernel and ::_bwd_kernel: the feature layer is
//   collapsed into M = W_F W_F^T [w, w], u = 2 W_F b_F, and
//   Phi = g.(M g) + u.g with g = act(z_L) (the constant |b_F|^2 is the
//   caller's).  M is assumed symmetric, as in the TPU kernel.  The TPU
//   kernel's lane packing of several refs per 128-lane register is layout
//   only and is not carried over.  K7 is k7_kernel and K8 is k8_kernel,
//   each a design of its own (below).
//
// Streams: the forward kernels propagate (z, p = d_v z, q = d_v^2 z), the
// backward kernels also r = d_g z with r0 = g_dz0[t, i]; the backward is one
// 4-stream forward pass and one reverse sweep (the TPU kernels' formulation,
// and K4's in csrc/pointwise.cu).
//
// Design of pw_fwd_kernel and pw_bwd_kernel (K5 where a width before the
// feature layer exceeds 32, K6 where k6_kernel does not take the chain).  A
// block
// owns (ref split s, stamp t, block of kTile points) and walks the refs j of
// its split in order; a tile is its
// kTile points against one ref.  Every layer's streams of the tile live in
// shared memory, feature-major with the points minor (rows of kRow floats),
// as in K3/K4, and the reverse sweep overwrites them with the cotangents in
// place.  The
// block's sums over j (value, hess, s_dz0, or ax/av cotangents) stay in
// shared memory, each entry owned by one thread, and are written once per
// block into a row of per-split partials; the weight gradients of a block go
// to its own row of a partials buffer, and each (point block, t, j) writes
// its ar cotangent row exactly once.  Small kernels then sum those rows in a
// fixed order, with no atomics, so the same shapes on the same card give
// bitwise-equal results on every call.  A ref with mask 0 is skipped (it
// adds exactly 0.0); points past n load zeros, get zero cotangents and are
// written nowhere.
//
// Saving against recomputing: the reverse sweep needs every layer's streams
// of a pair.  They stay in shared memory for the tile (about 4.6 KB a pair
// for K6 at hidden 20 x 8 and feature 128), which bounds the tile to 32
// pairs; recomputing the forward per layer would multiply the FMAs, and
// writing the streams to device memory is out of the question at 28 million
// pairs a step.
//
// What bounds it on an H100.  FP32 FMAs: at the KMV main path's shape (7
// stamps x 2,000 points x 2,000 refs = 28 million pairs, hidden 20 x 8,
// feature 128) K5 does about 21,000 FMAs a pair (three forward streams and
// one reverse), 1.2 TFLOP a call, and K6 about three times that; K7/K8 skip
// the 128-wide layer and do a little over half as much.  The inputs are a
// few MB.  The first design (pw_fwd_kernel, pw_bwd_kernel) keeps one float4
// shared-memory read per four FMAs and, at width 20, only 160 of a block's 256
// threads busy in the products.
//
// K7: one thread per point, the refs walked in registers (k7_kernel).  K7's
// outputs are per-point sums over refs, so a thread owns one point (t, i)
// and walks the refs j of its split in order with no block barrier:
// * work split: a block holds `threads` consecutive points of one stamp t
//   (128, or 64 / 32 where the shared memory below would not fit), so every
//   thread reads the same ref row ar[t, j] and mask[j] (broadcast loads, a
//   uniform mask branch).  Blocks are (ref split, stamp, point block); the
//   wrapper picks the splits (pde_inverse_torch/ops/cuda/pairwise.py
//   k7_splits) to round the grid to whole waves of resident blocks, and
//   every split writes one partial row that sum_rows adds in a fixed order;
// * streams in registers: (z, p, q) of the current layer, 3 W floats, build
//   the next layer's 3 W with f32 fmaf, each output summed over the input
//   feature in order and the bias added last; value and hess are
//   accumulated in registers, s_dz0[W] in shared memory (below), in ref
//   order.  Only Mg and M gp go through M (hess = 2 gp.(M gp) +
//   gq.(2 Mg + u) for a symmetric M);
// * weights in shared memory, loaded once per block: every layer's W_k
//   [W, W] and b_k [W], then M [W, W] and u [W] (4 (L (W^2 + W) + W^2 + W)
//   bytes).  Every lane reads the same address, a float4 along the output
//   feature, so one broadcast load feeds 12 FMAs (4 outputs x 3 streams) in
//   the forward and 4 in the reverse sweep, which reads W_k's rows as they
//   are (delta_k[i] = sum_j delta_{k+1}[j] W_k[i][j]);
// * the reverse sweep for s_dz0 needs act'(z_k) of every layer k < L (that
//   of z_L is used at once by the head): each thread keeps them in shared
//   memory, [k][thread][R] with rows of R = W floats (W + 4 where W is a
//   multiple of 8, so that 8 neighbouring threads' float4 accesses hit 32
//   different banks), and its s_dz0 sums after them as row k = L:
//   4 (L + 1) `threads` R bytes.  Every offset in a row is an immediate.
//   The sums there rather than in registers cost W / 2 float4 accesses a
//   pair and free W registers in every layer product;
// * widths are template parameters W in {8, 16, 20, 24, 32}: the wrapper
//   zero-pads every chain to the least W that holds its widest layer
//   (weights, biases, M and u); the points' w0 <= W is read as it is and
//   padded in registers.  Padding is exact: a padded feature's outgoing
//   weights, bias, M row and column and u entry are 0, so it adds exactly
//   0.0 everywhere, also where act(0) != 0 (softplus).  The number of layers
//   L <= 16 stays a runtime value;
// * shared memory and occupancy at the KMV main path (W = 20, L = 7, 128
//   threads): 13,440 B of weights + 71,680 B of act' + 10,240 B of s_dz0
//   sums = 95,360 B a block, so two blocks (256 threads) fit in an SM's
//   228 KB, and the register file would allow 255 registers a thread.  The
//   compiler aims at 168 (three blocks' worth) and spills to get there if
//   it must: the width-20 instantiations fit their 6 W = 120 live stream
//   values, the broadcast weights and the addresses in 167 registers with
//   no spill (CUDA 12.8) only with the s_dz0 sums out of registers and
//   immediate row offsets.  The wrapper's splits: with 2 x 132 = 264
//   resident blocks and 7 x 16 = 112 point blocks, 7 splits (784 blocks,
//   2.97 waves);
// * f32 throughout, with act_d's precise tanhf / expf / log1pf; a masked
//   ref is skipped (adds exactly 0.0); points past n compute and write
//   nothing.  FMAs a pair at width 20 and L = 7: 3 streams x 7 layers x 400
//   + 2 x 400 through M + 7 x 400 in the reverse sweep = 12,000, and 160
//   tanhf.
//
// K8: four lanes a pair, each with every fourth feature of the four streams;
// the weight gradients summed per warp, then over the warps (k8_kernel).  K8
// is the VJP of K7 with respect to (W_k, b_k, M, u, ax, av, ar): one forward
// pass of four streams (z, p, q and r = d_g z with r0 = g_dz0[t, i]) and one
// reverse sweep that needs every layer's four streams of the pair.  Saved, they are 4 W
// floats a layer and pair, so an SM's shared memory holds about 80 pairs at
// once: K7's thread per point does not carry over, and several lanes share a
// pair.  What bounds the products on this card is not the FMAs but the
// operands: shared memory returns 128 B a clock and SM, one 4-byte operand a
// lane, while the SM starts four warp FMAs a clock, so a loaded weight must
// feed four FMAs of its lane (K7's time is that of its broadcast float4 loads
// at 4 clocks each).  Hence:
// * work split: the four lanes of a quad own one pair, lane s the features
//   4 e + s (e < G = W / 4) of all four streams.  A warp holds 8 pairs and a
//   block of `threads` lanes threads / 4 consecutive points of one stamp (256
//   lanes, 64 points, where the shared memory below fits; 192 .. 32
//   otherwise) against the refs j of its split, one ref at a time.  Blocks
//   are (ref split, stamp, point block), the splits from k7_splits;
// * the activation needs no exchange: (z, p, q, r) of a feature sit in one
//   lane, which computes tanhf once and act', act'', act''' as polynomials of
//   it, then h = act z | act' p | act'' p^2 + act' q | act' r; the step back
//   through the activation is as local;
// * products: the quad writes its activated streams as four rows [stream][W]
//   of the row set H (scalar stores), and every lane reads them back as
//   float4s and builds its G outputs of all four streams, out_s[e] += h_s[i]
//   W_k[i][4 e + s]: one scalar weight load per four FMAs and one float4 of
//   activations per 4 G.  The reverse products hbar_s[e] = sum_j sbar_s[j]
//   W_k[4 e + s][j] read W_k's rows as float4s, each used for the four
//   streams, and the cotangent rows out of the set S that the weight
//   gradients need anyway.  The same routine gives (M g, M gp, M gq, M gs).
//   The weights' layout is K7's (zero-padded to W in {8, 16, 20, 24, 32},
//   loaded once a block).  No block barrier in the forward;
// * saved streams: a lane keeps its 4 G = W raw values of layer k = 1 ..
//   L - 1 (tanh(z) in the place of z) in its own row of that layer's row set;
//   layer 0's are recomputed from ax, av, ar and g_dz0.  A row set holds a
//   pair's four rows of R = k7_row(W) floats in 4 R + 4 floats, so that the 8
//   pairs of a warp start 20 banks apart and their scalar accesses hit 32
//   different banks;
// * weight gradients are the one reduction over pairs: Wbar_k = sum over the
//   block's rows (pair, stream) of h_s^T sbar_s, a [W, threads] x [threads, W]
//   product a layer and ref.  The quads write h_s over their saved rows (set
//   H for layer 0 and for the head) and sbar_s into the set S.  The sum takes
//   two steps (k8_warp_grads, k8_add_warps):
//   1. per warp: each warp sums its own 8 pairs' 32 rows in registers, a lane
//      a block of 4 x 4 of Wbar_k (4 x 8 at W = 24 and 32; at W = 20, 25 of
//      the 32 lanes), reading a float4 of h and one of sbar a row: two loads
//      per 16 FMAs, no shuffle, and every warp works.  A warp's float4 load
//      takes four wavefronts (one a quarter-warp) wherever a quarter reads
//      more than one address, as these do (measured on an H100: 4.0 clocks
//      an SM a warp-load against 2.2 where every quarter reads one), so the
//      loads bound this product at twice its FMA time.  At W = 8 and 16
//      there are fewer blocks than lanes: 8 and 2 lanes share a block, each
//      with a slice of the pairs, and add their slices by shuffles in a
//      fixed order;
//   2. over the warps, in warp order: each warp stores its W^2 + W sums
//      (with the bias's) as a row of a scratch buffer, the block passes one
//      barrier a layer, and each warp adds a like share of the float4
//      columns over the warps in warp order to the accumulators of the whole
//      chain in shared memory, each column by one thread alone.  It does so
//      during the next layer's product: at W <= 20 a thread loads its column
//      before the product and adds it after, so that the loads wait behind
//      the FMAs and not at the barrier.  The two buffers alternate from layer
//      to layer, so no second barrier is needed.
//   The sums are stored blocked (a lane's block as consecutive float4s of
//   the warps' lanes), so that the stores and the column sums take
//   consecutive float4s, and a block's row of w_partials is unblocked at its
//   end.  A block of one warp adds its sums to the accumulators itself and
//   has no scratch.  The bias gradients ride along (the sum of the z stream's
//   sbar rows), and the head is one more such product with rows H = L1 | 2
//   gh gp | 0 | 0 and S = g | gp | u's cotangent | 0, giving Mbar and ubar.
//   A block writes its accumulators once, at its end, as one row of
//   w_partials, which sum_rows adds in a fixed order: no atomics, two calls
//   are bitwise equal.  The product on the tensor cores (mma m16n8k8, 3xTF32)
//   was counted and not built: splitting each fragment into its big and
//   small parts costs 18 instructions for 3 mma a k-step, as many
//   instructions a warp as the FMA version, and pre-split rows would double
//   the sets H and S;
// * barriers a 64-pair tile: one a layer and one for the head, for the
//   scratch, and one at the tile's end (L + 2).  A warp reads only its own
//   pairs' rows, so max(L, 1) + 1 row sets do: between a layer's reads of S
//   and the next layer's writes a warp's lanes need only __syncwarp;
// * ax and av cotangents stay in registers over the block's refs; the ref's
//   row is summed over the warp's 8 pairs by shuffles, over the warps through
//   shared memory, and each (point block, t, j) writes its ar row exactly once
//   (zeros for a masked ref, which is otherwise skipped);
// * shared memory at the KMV main path (W = 20, L = 7, 256 lanes): 26,880 B
//   of weights and accumulators + 172,032 B of rows + 26,880 B of scratch +
//   640 B of ref-row partials = 226,432 B (rows: 8 sets x 64 pairs x 84
//   floats; scratch: 2 x 8 warps x 420 floats), so one block (8 warps) an
//   SM (a block may have 232,448 B); with 7 x 32 point blocks on 132
//   resident blocks the wrapper takes 4 splits (896 blocks, 6.79 waves).
//   Where the rows and the scratch would not fit (many layers, width 24 or
//   32) the block shrinks, and a block of one warp needs no scratch;
// * f32 throughout with the precise tanhf / expf / log1pf; padding is exact
//   as for K7, and the wrapper drops the padded entries' gradients; lanes of
//   points past n run with zero inputs and a zero mask factor, so that they
//   add exactly 0.0 and the block's barriers and shuffles stay whole.
//   FMAs a pair at width 20 and L = 7: 4 streams x (7 + 1) x 400 forward,
//   4 x 7 x 400 in the reverse products, 4 x 7 x 400 + 2 x 400 in the weight
//   gradients = 36,000, and 160 tanhf.  What bounds it: operations (the
//   inputs are a few MB), and under them the shared-memory operands: a
//   weight-gradient row takes two float4 loads per 16 FMAs of a lane.
//
// K6 on K8's lane quads (k6_kernel), for chains whose widths before the
// feature layer are <= 32 (33 to 64: on lane octets, below; wider chains keep
// pw_bwd_kernel, K6's first design, the 32-point tiles above, chosen by shape
// in the wrapper).  The hidden layers run as in K8, through K8's device
// functions with four lanes a pair (k8_product, k8_product_t, k8_mix,
// k8_back, k8_save, k8_restore): lane s of a quad owns the features 4 e + s
// of the four streams, the same padding and splits.  The weight gradients
// are K6's own (k8_weight_grads, K8's first design): after a barrier every
// thread sums a 4 x 4 block of them over one of S slices of the block's
// pairs, the slices added by shuffles, so the rows are read across warps
// and two sets S alternate.  The square head
// Phi = |z_F|^2 runs through the feature layer W_F [W, F] (F = 128 at the
// KMV MLP), whose four F-wide streams are never held whole nor saved:
// * the feature layer is streamed in chunks of W features, in chunk order,
//   each chunk a [W, W] block of W_F's columns and its W biases, laid out
//   as one more hidden layer is (F zero-padded to whole chunks: 128 -> 140 at
//   W = 20, 7 chunks).  Layer L's activated streams are written once into
//   the set H; for each chunk, k8_product gives the chunk's (z, p, q, r)_F,
//   the lane computes their cotangents zbar = c (2 g_val z + 2 g_hess q +
//   2 r), pbar = 4 c g_hess p, qbar = 2 c g_hess z, rbar = 2 c z (c = the
//   ref's mask, 0 past n) and writes them into S[c & 1], k8_product_t adds
//   their product with the chunk's W_F^T to the lane's hbar registers (W
//   wide, summed over the chunks in order), and after one barrier
//   k8_weight_grads adds the chunk's W_F and b_F gradients to the block's
//   accumulators.  The two sets S alternate between chunks, so one barrier a
//   chunk suffices; one more barrier after the head frees H and S for the
//   reverse sweep.  Padded features have zero weights and biases: they add
//   exactly 0.0 and the wrapper drops their gradients;
// * weights: L x (W_k, b_k) then the chunks, 4 (L + chunks) (W^2 + W) bytes,
//   and as many gradient accumulators; rows: max(L, 1) + 2 row sets of 4 R +
//   4 floats a pair (k6_rows: H and two sets S); the ref-row partials;
// * shared memory at the KMV main path (W = 20, L = 7, 7 chunks, 224 lanes):
//   47,040 B of weights and accumulators + 169,344 B of rows + 560 B of
//   ref-row partials = 216,944 B, one block (7 warps, 56 pairs) an SM.  256
//   lanes would need 241,216 B, more than a block may have; 224 rather than
//   192 lanes keeps 200 threads busy in the weight-gradient products (8
//   slices of the 25 4 x 4 blocks) where 192 would keep 100.  With 7 x 36
//   point blocks on 132 resident blocks the wrapper takes 1 split (252
//   blocks, 1.91 waves);
// * FMAs a pair at width 20, L = 7 and F = 128: 4 streams x 7 x 400 forward,
//   3 x 4 x 20 x 140 in the head (product, hbar and weight gradients over the
//   padded 140 features), 2 x 4 x 7 x 400 in the reverse sweep = 33,600 +
//   33,600 = 67,200 (64,320 without the padding), and 160 tanhf.  Barriers
//   a ref: L + chunks + 2.  What bounds it: operations, and under them the
//   shared-memory operands as in K8.
//
// K6 on lane octets (k6_kernel at W = 48 and 64), for chains whose widths
// before the feature layer are 33 to 64 and whose plan fits.  Four lanes a
// pair at W = 64 would hold 16 features of each stream a lane and spill;
// eight lanes, lane s with the features 8 e + s (e < G = W / 8), hold what
// the quads hold at W = 24 and 32 (x, hb and cot [4][G]; bz, bp, br, sumz,
// sump [G]; G = 6 or 8).  The kernel is the quads' k6_kernel with the lanes
// a pair NL a constant of the width (k8_lanes): K8's device functions take
// NL as a template parameter, 4 in K8 and in k6_kernel at W <= 32, whose
// code is unchanged.  What differs at NL = 8:
// * work split: a warp holds 4 pairs, a block of T lanes T / 8 consecutive
//   points of one stamp; blocks are (ref split, stamp, point block), the
//   splits from k7_splits;
// * row sets: a pair's four rows of R = W + 4 floats in 4 R + 8 floats, so
//   that the 4 pairs of a warp start 24 banks apart and the scalar stores of
//   k8_to_rows, 8 consecutive banks a pair, hit 32 different banks (with the
//   quads' 4 R + 4, 20 banks apart, the fourth pair's banks would overlap
//   the first's).
//   A lane saves its 4 G = W / 2 raw values as half of row s / 2 of its
//   pair's rows (k8_save), where two lanes of an octet share a bank quad:
//   those float4 stores and loads, 8 (W = 64) or 6 (W = 48) a lane, layer and
//   ref, take twice the fewest wavefronts, against 2,048 (1,152) FMAs of the
//   lane in the layer's products;
// * weights: a [W, W] block is stored with row r's float4 chunk c at c ^
//   k8_swz(r) (r & 7 at W = 64, (r >> 1) & 3 at W = 48, a permutation inside
//   aligned groups of 8 or 4 chunks), so that in k8_product_t the rows 8 e +
//   s that a pair's eight lanes read at once fall on eight bank quads
//   (unswizzled, rows of 64 floats all start on one quad and rows of 48 on
//   two: 8 and 4 wavefronts a float4); k8_product's scalar reads of row i at
//   the columns 8 e + s stay on 8 consecutive banks (two chunks), each
//   address an immediate plus s or s ^ 4.  Biases and the gradient
//   accumulators keep the plain layout;
// * weight gradients: at W = 64 a layer has 16 x 16 = 256 blocks of 4 x 4,
//   so with 256 lanes every lane owns one (S = 1; at W = 20 the quads keep
//   200 of 224 busy).  The octets give a thread blocks of 8 x 4 instead
//   (kK6OctetGradRows, two pair slices at 256 lanes), so that a loaded float
//   feeds 2.7 FMAs rather than 2: 395.2-397.1 ms against 401.0-401.4 for 4 x
//   4 at 64 -> 64 -> 128, in turns on an NVIDIA H100 80GB HBM3 at 700 W;
// * the feature layer in chunks of W as at W <= 32: F = 128 is 2 chunks at W
//   = 64, 3 padded to 144 at W = 48;
// * shared memory at 64 -> 64 -> 128 (W = 64, L = 1, 2 chunks, 256 lanes):
//   99,840 B of weights and accumulators + 107,520 B of rows + 2,048 B of
//   ref-row partials = 209,408 B, one block (8 warps, 32 pairs) an SM; with 7
//   x 63 point blocks on 132 resident blocks the wrapper takes 2 splits (882
//   blocks, 6.68 waves).  At hidden 64 x 3 (L = 2) 160 lanes and 224,000 B
//   (192 lanes would need 242,176 B); 64 lanes at L = 3, 32 at L = 4; at L =
//   5 the weights and accumulators alone (232,960 B with 2 chunks) exceed a
//   block's 232,448 B, and the wrapper sends the chain to pw_bwd_kernel,
//   which raises for want of shared memory;
// * the ref's row of ar cotangents: the warp's 4 pairs summed by shuffles at
//   lane offsets 8 and 16; w0 <= W <= 2 T, so a lane writes up to two of its
//   w0 entries;
// * FMAs a pair at 64 -> 64 -> 128: 4 streams x 4,096 forward, 3 x 4 x 64 x
//   128 in the head (product, hbar and weight gradients), 2 x 4 x 4,096 in
//   the reverse sweep = 147,456 FMAs a pair (no padding), and 128 tanhf in
//   the forward pass.  What bounds it: operations (123.247 ms at 28 million
//   pairs), and under them the shared-memory operands, as at W <= 32.
//
// K5 on K7's thread per point (k5_kernel), for chains whose widths before the
// feature layer are <= 32; wider chains keep pw_fwd_kernel, K5's first design
// (the 32-point tiles above), chosen by shape in the wrapper.  K5 is K7's
// function with the square head Phi = |z_F|^2 in place of the collapsed one,
// so it takes K7's design whole: a thread owns one point (t, i) and walks the
// refs of its split in order with no block barrier, the splits from
// k7_splits, the hidden layers through k7_layer unchanged (the streams (z, p,
// q) in registers, act'(z_k) in the thread's shared-memory row k, weights read
// as broadcast float4s) and the reverse sweep through k7_sweep, as K7's.  The
// head is not collapsed into M = W_F W_F^T (that is K7's function): the
// feature layer W_F [W, F] (F = 128 at the KMV MLP) is streamed in chunks of 4
// features, in feature order, and nothing F-wide is ever held:
// * layer L's streams are activated in place and act'(z_L) stays in
//   registers, as K7's head keeps it;
// * for each chunk, one pass over W_F's W rows at the chunk's 4 columns (a
//   broadcast float4 each, feeding 12 FMAs) gives the chunk's (z, p, q)_F, the
//   bias added last; the thread adds z_F^2 to its value sum and p_F^2 +
//   z_F q_F to its hess sum, and a second pass over the same rows (4 FMAs a
//   float4) adds 2 z_F W_F^T to a W-wide register array hbar.  After the last
//   chunk, delta = hbar * act'(z_L) = dPhi/dz_L starts the reverse sweep;
// * weights in shared memory, loaded once per block: L x (W_k, b_k), then W_F
//   [W, F4] row-major and b_F [F4], F zero-padded to F4, a multiple of 4 (a
//   padded feature adds exactly 0.0): 4 (L (W^2 + W) + (W + 1) F4) bytes; the
//   rows of act' and the s_dz0 sums as K7's, 4 (L + 1) `threads` R bytes;
// * shared memory at the KMV main path (W = 20, L = 7, F = 128, 128 threads):
//   22,512 B of weights + 81,920 B of act' and s_dz0 rows = 104,432 B, so two
//   blocks (256 threads) fit an SM, as K7's.  The wrapper's splits: with 264
//   resident blocks and 7 x 16 point blocks, 7 splits (784 blocks, 2.97
//   waves).  Where the rows would not fit (many layers at width 32), the block
//   takes 64 or 32 points;
// * registers: about 112 live values at W = 20 (60 stream values, 20 of
//   act'(z_L), 20 of hbar, 12 chunk outputs), against K7's 120;
// * f32 throughout, with act_d's precise tanhf / expf / log1pf; widths,
//   padding, masked refs (skipped: they add exactly 0.0), points past n
//   (compute and write nothing) and the fixed order of the sums as K7's.
//   FMAs a pair at width 20, L = 7 and F = 128: 3 x 7 x 400 forward, 3 x 2,560
//   for the head's streams and 2,560 for hbar, 7 x 400 in the reverse sweep =
//   21,440 (K7: 12,000), and 160 tanhf; broadcast float4 loads 700 + 640 +
//   640 + 700 = 2,680 (K7: 1,500).  What bounds it: operations (the inputs
//   are a few MB), and under them the broadcast loads, one per 8 FMAs on
//   average (12 in the forward products, 4 in hbar and the reverse sweep).
//
// sum_rows, the fixed-order row sum that finishes every kernel's partial rows
// (K5 and K7 one launch a call, K6 and K8 three), keeps its order a function
// of (rows, len) alone: chunks of at least 64 consecutive rows, each summed by
// one warp for 32 columns, the chunk sums added in chunk order through a
// thread-block cluster's distributed shared memory (csrc/row_chunks.cuh).
// A thread a column walking every row would give K8's weight-gradient
// partials (896 rows x 3,360 columns at the KMV main path) 14 blocks on 132
// SMs, each thread 896 dependent adds.  What bounds it: bytes (each partial
// read once; 12 MB there, 3.6 us at 3.35 TB/s).
//
// S1, the checks of scripts/diag_packed_onchip.py (replacing its Pallas
// kernels, which checked the TPU kernels' lane-packing constructs), are the
// s1_* entry points at the end, built from the very device functions above
// (pair_rows, forward_product on an M layer, sum_rows), so that they test
// what K5 and K6 run; of K7's and K8's constructs they cover sum_rows only
// (the wrappers s1_packed_sums and s1_packed_sums_bwd run the whole K7 and K8
// with one ref split).  The pair rows run a block a ref, with no loop over
// refs and its barriers; the M layer runs in one block; both set their
// shared-memory limit once per process, not per call.

#include <cstdint>

#include <cuda_runtime.h>

#include "launch.cuh"
#include "row_chunks.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;          // points per tile (one ref each)
constexpr int kRow = kTile + 4;    // floats per feature row in shared memory
constexpr int kGroup = 4;          // points per thread in a layer product
constexpr int kGroups = kTile / kGroup;
constexpr int kMaxMid = 17;        // 16 layers after the first, plus M
constexpr int kTanh = 0;
constexpr int kSilu = 1;
constexpr int kSoftplus = 2;
static_assert(kThreads == 32 * row_chunks::kWarps, "sum_rows_kernel runs row_chunks::kWarps warps a block");

struct Net {
  int n_mid;
  int w[kMaxMid + 1];    // widths: w[0] = w0, w[k + 1] = output width of layer k
  int p_off[kMaxMid];    // W_k [w_k, w_{k+1}] at params + p_off[k], b_k right after
  int t_off[kMaxMid];    // W_k^T [w_{k+1}, w_k] at params_t + t_off[k]
  int row[kMaxMid + 1];  // first shared-memory row of layer k's streams
  int rows;              // rows of all layers (the sum of the widths)
  int tmp_rows;          // rows of the activated copy (widest input, padded to 4)
};

template <int ACT>
__device__ __forceinline__ void act_d(float z, float& a0, float& a1, float& a2, float& a3) {
  if constexpr (ACT == kTanh) {
    const float a = tanhf(z);
    const float d1 = 1.0f - a * a;
    a0 = a;
    a1 = d1;
    a2 = -2.0f * a * d1;
    a3 = d1 * (4.0f * a * a - 2.0f * d1);
  } else if constexpr (ACT == kSilu) {
    const float s = 1.0f / (1.0f + expf(-z));
    const float s1 = s * (1.0f - s);
    const float s2 = s1 * (1.0f - 2.0f * s);
    const float s3 = s2 * (1.0f - 2.0f * s) - 2.0f * s1 * s1;
    a0 = z * s;
    a1 = s + z * s1;
    a2 = 2.0f * s1 + z * s2;
    a3 = 3.0f * s2 + z * s3;
  } else {
    const float s = 1.0f / (1.0f + expf(-z));
    const float s1 = s * (1.0f - s);
    a0 = fmaxf(z, 0.0f) + log1pf(expf(-fabsf(z)));
    a1 = s;
    a2 = s1;
    a3 = s1 * (1.0f - 2.0f * s);
  }
}

template <int ACT>
__device__ __forceinline__ float act_d1(float z) {
  float a0, a1, a2, a3;
  act_d<ACT>(z, a0, a1, a2, a3);
  return a1;
}

// Shared memory of a block: the streams of every layer, their activated
// copy, the tile inputs cached for the block (ax, av, r0), two w0-row
// accumulators and a few per-point scalar rows.
struct Smem {
  float* sm;     // [NS][rows][kRow]
  float* tmp;    // [NS][tmp_rows][kRow]
  float* cax;    // [w0][kRow]
  float* cav;    // [w0][kRow]
  float* cr0;    // [w0][kRow]
  float* acc1;   // [w0][kRow]
  float* acc2;   // [w0][kRow]
  float* sc;     // [kScalarRows][kRow]
};
constexpr int kScalarRows = 4;  // value / hess sums (forward); g_val, g_hess (backward)

__host__ __device__ inline int extra_rows(int w0) { return 5 * w0 + kScalarRows; }

__device__ inline Smem carve(float* base, const Net& net, int ns) {
  Smem s;
  const int w0 = net.w[0];
  s.sm = base;
  s.tmp = s.sm + static_cast<size_t>(ns) * net.rows * kRow;
  s.cax = s.tmp + static_cast<size_t>(ns) * net.tmp_rows * kRow;
  s.cav = s.cax + w0 * kRow;
  s.cr0 = s.cav + w0 * kRow;
  s.acc1 = s.cr0 + w0 * kRow;
  s.acc2 = s.acc1 + w0 * kRow;
  s.sc = s.acc2 + w0 * kRow;
  return s;
}

// row i of stream s of layer k, and row i of stream s of the activated copy
__device__ __forceinline__ float* srow(const Smem& S, const Net& net, int s, int k, int i) {
  return S.sm + static_cast<size_t>(s * net.rows + net.row[k] + i) * kRow;
}
__device__ __forceinline__ float* trow(const Smem& S, const Net& net, int s, int i) {
  return S.tmp + static_cast<size_t>(s * net.tmp_rows + i) * kRow;
}
__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }
__device__ __forceinline__ void fma4(float4& acc, float4 x, float w) {
  acc.x = fmaf(x.x, w, acc.x);
  acc.y = fmaf(x.y, w, acc.y);
  acc.z = fmaf(x.z, w, acc.z);
  acc.w = fmaf(x.w, w, acc.w);
}

// rows [t, i0 + p, 0..w) of a [nt, n, w] array -> cache rows [f][p], zero past n
__device__ void load_points(float* dst, const float* __restrict__ src, int t, int i0, int n, int w) {
  for (int idx = threadIdx.x; idx < kTile * w; idx += kThreads) {
    const int p = idx / w;
    const int f = idx - p * w;
    const int i = i0 + p;
    dst[f * kRow + p] = i < n ? src[(static_cast<size_t>(t) * n + i) * w + f] : 0.0f;
  }
}

// Activated streams of layer k's inputs into the copy:
// h = act(z), hp = act' p, hq = act'' p^2 + act' q, hr = act' r.
template <int NS, int ACT>
__device__ void activate(const Smem& S, const Net& net, int k) {
  const int win = net.w[k];
  for (int idx = threadIdx.x; idx < win * kTile; idx += kThreads) {
    const int i = idx / kTile;
    const int p = idx - i * kTile;
    float a0, a1, a2, a3;
    act_d<ACT>(srow(S, net, 0, k, i)[p], a0, a1, a2, a3);
    const float dp = srow(S, net, 1, k, i)[p];
    const float dq = srow(S, net, 2, k, i)[p];
    trow(S, net, 0, i)[p] = a0;
    trow(S, net, 1, i)[p] = a1 * dp;
    trow(S, net, 2, i)[p] = a2 * dp * dp + a1 * dq;
    if constexpr (NS == 4) trow(S, net, 3, i)[p] = a1 * srow(S, net, 3, k, i)[p];
  }
}

// Layer k's streams out of the activated copy: out_s = h_s W (+ b for z).
template <int NS>
__device__ void forward_product(const Smem& S, const Net& net, int k, const float* __restrict__ params) {
  const int win = net.w[k];
  const int wout = net.w[k + 1];
  const float* __restrict__ W = params + net.p_off[k];
  const float* __restrict__ b = W + win * wout;
  for (int item = threadIdx.x; item < kGroups * wout; item += kThreads) {
    const int g = item / wout;
    const int j = item - g * wout;
    float4 acc[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = 0; i < win; ++i) {
      const float w = __ldg(W + static_cast<size_t>(i) * wout + j);
#pragma unroll
      for (int s = 0; s < NS; ++s) fma4(acc[s], ld4(trow(S, net, s, i) + g * kGroup), w);
    }
    const float bj = __ldg(b + j);
    acc[0].x += bj;
    acc[0].y += bj;
    acc[0].z += bj;
    acc[0].w += bj;
#pragma unroll
    for (int s = 0; s < NS; ++s) st4(srow(S, net, s, k + 1, j) + g * kGroup, acc[s]);
  }
}

template <int NS, int ACT>
__device__ void forward(const Smem& S, const Net& net, const float* __restrict__ params) {
  for (int k = 0; k < net.n_mid; ++k) {
    activate<NS, ACT>(S, net, k);
    __syncthreads();
    forward_product<NS>(S, net, k, params);
    __syncthreads();
  }
}

// The tile's layer-0 streams against ref row ar_j [w0]: z = ax - ar_j,
// p = av, q = 0 and, with four streams, r = r0.
template <int NS>
__device__ void pair_rows(const Smem& S, const Net& net, const float* __restrict__ ar_j) {
  const int w0 = net.w[0];
  for (int idx = threadIdx.x; idx < w0 * kTile; idx += kThreads) {
    const int f = idx / kTile;
    const int p = idx - f * kTile;
    srow(S, net, 0, 0, f)[p] = S.cax[f * kRow + p] - __ldg(ar_j + f);
    srow(S, net, 1, 0, f)[p] = S.cav[f * kRow + p];
    srow(S, net, 2, 0, f)[p] = 0.0f;
    if constexpr (NS == 4) srow(S, net, 3, 0, f)[p] = S.cr0[f * kRow + p];
  }
}

// Reverse sweep of the forward kernel: delta_k = (delta_{k+1} W_k^T) *
// act'(z_k), written over z_k, for k = k_top .. 0; the first product's sum
// is scaled by `top_scale` (exact in floating point for 2).
template <int ACT>
__device__ void delta_sweep(const Smem& S, const Net& net, int k_top, float top_scale,
                            const float* __restrict__ params_t) {
  for (int k = k_top; k >= 0; --k) {
    const int win = net.w[k];
    const int wout = net.w[k + 1];
    const float* __restrict__ Wt = params_t + net.t_off[k];
    const float scale = k == k_top ? top_scale : 1.0f;
    for (int item = threadIdx.x; item < kGroups * win; item += kThreads) {
      const int g = item / win;
      const int i = item - g * win;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int j = 0; j < wout; ++j) {
        fma4(acc, ld4(srow(S, net, 0, k + 1, j) + g * kGroup), __ldg(Wt + static_cast<size_t>(j) * win + i));
      }
      float* zp = srow(S, net, 0, k, i) + g * kGroup;
      const float4 z = ld4(zp);
      acc.x = acc.x * scale * act_d1<ACT>(z.x);
      acc.y = acc.y * scale * act_d1<ACT>(z.y);
      acc.z = acc.z * scale * act_d1<ACT>(z.z);
      acc.w = acc.w * scale * act_d1<ACT>(z.w);
      st4(zp, acc);
    }
    __syncthreads();
  }
}

// K5 where a width before the feature layer exceeds 32: the square head's
// forward on 32-point tiles.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    pw_fwd_kernel(Net net, int nt, int n, int m, int chunk, const float* __restrict__ ax,
                  const float* __restrict__ av, const float* __restrict__ ar,
                  const float* __restrict__ mask, const float* __restrict__ params,
                  const float* __restrict__ params_t, float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  const Smem S = carve(reinterpret_cast<float*>(smem4), net, 3);
  const int n_iblk = (n + kTile - 1) / kTile;
  const int iblk = blockIdx.x % n_iblk;
  const int t = (blockIdx.x / n_iblk) % nt;
  const int split = blockIdx.x / (n_iblk * nt);
  const int i0 = iblk * kTile;
  const int j_begin = split * chunk;
  const int j_end = min(m, j_begin + chunk);
  const int w0 = net.w[0];
  const int L = net.n_mid;
  float* acc_val = S.sc;
  float* acc_hess = S.sc + kRow;

  load_points(S.cax, ax, t, i0, n, w0);
  load_points(S.cav, av, t, i0, n, w0);
  for (int idx = threadIdx.x; idx < w0 * kRow; idx += kThreads) S.acc1[idx] = 0.0f;
  for (int idx = threadIdx.x; idx < 2 * kRow; idx += kThreads) S.sc[idx] = 0.0f;
  __syncthreads();

  const int lane = threadIdx.x % 32;
  for (int j = j_begin; j < j_end; ++j) {
    const float mk = __ldg(mask + j);
    if (mk == 0.0f) continue;  // block-uniform
    pair_rows<3>(S, net, ar + (static_cast<size_t>(t) * m + j) * w0);
    __syncthreads();
    forward<3, ACT>(S, net, params);

    // head: per point, one warp reduces over the last layer's features
    for (int p = threadIdx.x / 32; p < kTile; p += kThreads / 32) {
      float sv = 0.0f, sh = 0.0f;
      for (int f = lane; f < net.w[L]; f += 32) {
        const float z = srow(S, net, 0, L, f)[p];
        const float dz = srow(S, net, 1, L, f)[p];
        sv += z * z;
        sh += dz * dz + z * srow(S, net, 2, L, f)[p];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sv += __shfl_xor_sync(0xffffffffu, sv, o);
        sh += __shfl_xor_sync(0xffffffffu, sh, o);
      }
      if (lane == 0) {
        acc_val[p] += mk * sv;
        acc_hess[p] += mk * (2.0f * sh);
      }
    }
    __syncthreads();
    delta_sweep<ACT>(S, net, L - 1, 2.0f, params_t);
    for (int idx = threadIdx.x; idx < w0 * kTile; idx += kThreads) {
      const int f = idx / kTile;
      const int p = idx - f * kTile;
      S.acc1[f * kRow + p] += mk * srow(S, net, 0, 0, f)[p];
    }
    __syncthreads();
  }

  // this split's sums: value | hess | s_dz0, each [nt, n(, w0)]
  const size_t tn = static_cast<size_t>(nt) * n;
  float* out = partials + static_cast<size_t>(split) * tn * (2 + w0);
  for (int p = threadIdx.x; p < kTile; p += kThreads) {
    if (i0 + p < n) {
      out[static_cast<size_t>(t) * n + i0 + p] = acc_val[p];
      out[tn + static_cast<size_t>(t) * n + i0 + p] = acc_hess[p];
    }
  }
  for (int idx = threadIdx.x; idx < kTile * w0; idx += kThreads) {
    const int p = idx / w0;
    const int f = idx - p * w0;
    if (i0 + p < n) out[2 * tn + (static_cast<size_t>(t) * n + i0 + p) * w0 + f] = S.acc1[f * kRow + p];
  }
}

// -- K7 ------------------------------------------------------------------------

constexpr int kK7MaxThreads = 128;  // points per block, at most

// floats of K7's weights in shared memory: L x (W_k, b_k), M, u
__host__ __device__ constexpr int k7_weight_floats(int w, int n_layers) {
  return n_layers * (w * w + w) + w * w + w;
}

// floats of one thread's row of act' (or of s_dz0 sums): w, or w + 4 where
// w is a multiple of 8, so that rows start 4 banks apart modulo 8 and the
// float4 accesses of 8 neighbouring threads hit 32 different banks
__host__ __device__ constexpr int k7_row(int w) { return w % 8 == 0 ? w + 4 : w; }

size_t k7_shared_bytes(int w, int threads, int n_layers) {
  return sizeof(float) * (static_cast<size_t>(k7_weight_floats(w, n_layers)) +
                          static_cast<size_t>(n_layers + 1) * threads * k7_row(w));
}

// One hidden layer for one point: activates the streams (z, p, q) in place,
// keeps act'(z) in the thread's row dk, and replaces them by the layer's
// outputs z W_k + b_k, p W_k, q W_k.
template <int W, int ACT>
__device__ __forceinline__ void k7_layer(const float* __restrict__ Wk, float* __restrict__ dk,
                                         float (&z)[W], float (&p)[W], float (&q)[W]) {
#pragma unroll
  for (int f = 0; f < W; f += 4) {
    float d[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float a0, a2, a3;
      act_d<ACT>(z[f + e], a0, d[e], a2, a3);
      const float pf = p[f + e];
      z[f + e] = a0;
      p[f + e] = d[e] * pf;
      q[f + e] = a2 * pf * pf + d[e] * q[f + e];
    }
    st4(dk + f, make_float4(d[0], d[1], d[2], d[3]));
  }
  float zo[W], po[W], qo[W];
#pragma unroll
  for (int j = 0; j < W; ++j) zo[j] = po[j] = qo[j] = 0.0f;
#pragma unroll
  for (int i = 0; i < W; ++i) {
#pragma unroll
    for (int j = 0; j < W; j += 4) {
      const float4 w = ld4(Wk + i * W + j);
      zo[j] = fmaf(z[i], w.x, zo[j]);
      zo[j + 1] = fmaf(z[i], w.y, zo[j + 1]);
      zo[j + 2] = fmaf(z[i], w.z, zo[j + 2]);
      zo[j + 3] = fmaf(z[i], w.w, zo[j + 3]);
      po[j] = fmaf(p[i], w.x, po[j]);
      po[j + 1] = fmaf(p[i], w.y, po[j + 1]);
      po[j + 2] = fmaf(p[i], w.z, po[j + 2]);
      po[j + 3] = fmaf(p[i], w.w, po[j + 3]);
      qo[j] = fmaf(q[i], w.x, qo[j]);
      qo[j + 1] = fmaf(q[i], w.y, qo[j + 1]);
      qo[j + 2] = fmaf(q[i], w.z, qo[j + 2]);
      qo[j + 3] = fmaf(q[i], w.w, qo[j + 3]);
    }
  }
  const float* __restrict__ b = Wk + W * W;
#pragma unroll
  for (int j = 0; j < W; ++j) {
    z[j] = zo[j] + b[j];
    p[j] = po[j];
    q[j] = qo[j];
  }
}

// The reverse sweep for one point and ref: delta = dPhi/dz_L becomes dPhi/dz0
// through delta_k = (delta_{k+1} W_k^T) * act'(z_k) for k = L - 1 .. 0 (W_k's
// rows read as they are, act'(z_k) from the thread's row dk0 + k stride), and
// is added, times the ref's mask mk, to the thread's s_dz0 sums at acc.
template <int W>
__device__ __forceinline__ void k7_sweep(const float* __restrict__ sw, const float* dk0, int stride, int L,
                                         float mk, float (&delta)[W], float* acc) {
#pragma unroll 1
  for (int k = L - 1; k >= 0; --k) {
    const float* __restrict__ Wk = sw + k * (W * W + W);
    const float* dk = dk0 + k * stride;
    float nd[W];
#pragma unroll
    for (int r = 0; r < W; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int c = 0; c < W; c += 4) {
        const float4 w = ld4(Wk + r * W + c);
        s = fmaf(delta[c], w.x, s);
        s = fmaf(delta[c + 1], w.y, s);
        s = fmaf(delta[c + 2], w.z, s);
        s = fmaf(delta[c + 3], w.w, s);
      }
      nd[r] = s;
    }
#pragma unroll
    for (int f = 0; f < W; f += 4) {
      const float4 d = ld4(dk + f);
      delta[f] = nd[f] * d.x;
      delta[f + 1] = nd[f + 1] * d.y;
      delta[f + 2] = nd[f + 2] * d.z;
      delta[f + 3] = nd[f + 3] * d.w;
    }
  }
#pragma unroll
  for (int f = 0; f < W; f += 4) {
    float4 a = ld4(acc + f);
    a.x += mk * delta[f];
    a.y += mk * delta[f + 1];
    a.z += mk * delta[f + 2];
    a.w += mk * delta[f + 3];
    st4(acc + f, a);
  }
}

// One point's sums over the refs of a split into the split's partial row:
// value | hess | s_dz0, each [nt, n(, w0)].
template <int W>
__device__ __forceinline__ void k7_write(float* __restrict__ partials, int split, int nt, int n, int w0,
                                         size_t ti, float val, float hess, const float* acc) {
  const size_t tn = static_cast<size_t>(nt) * n;
  float* out = partials + static_cast<size_t>(split) * tn * (2 + w0);
  out[ti] = val;
  out[tn + ti] = hess;
  float* o = out + 2 * tn + ti * w0;
#pragma unroll
  for (int f = 0; f < W; ++f) {
    if (f < w0) o[f] = acc[f];
  }
}

// K7: for the point (t, i) of this thread and the refs of this block's
// split, value, hess and s_dz0 into the split's partial row (see the header).
// weights: the zero-padded [L x (W_k [W, W], b_k [W]), M [W, W], u [W]].
template <int W, int ACT>
__global__ void __launch_bounds__(kK7MaxThreads)
    k7_kernel(int n_layers, int w0, int nt, int n, int m, int chunk, const float* __restrict__ ax,
              const float* __restrict__ av, const float* __restrict__ ar,
              const float* __restrict__ mask, const float* __restrict__ weights,
              float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  const int L = n_layers;
  const int T = blockDim.x;
  const int n_w4 = k7_weight_floats(W, L) / 4;  // W is a multiple of 4
  for (int idx = threadIdx.x; idx < n_w4; idx += T) {
    smem4[idx] = __ldg(reinterpret_cast<const float4*>(weights) + idx);
  }
  __syncthreads();
  const float* sw = reinterpret_cast<const float*>(smem4);
  const float* sM = sw + L * (W * W + W);
  const float* su = sM + W * W;
  // this thread's rows: act'(z_k) at dk0 + k T R, its s_dz0 sums at acc
  constexpr int R = k7_row(W);
  float* dk0 = reinterpret_cast<float*>(smem4 + n_w4) + threadIdx.x * R;
  float* acc = dk0 + L * T * R;

  const int n_iblk = (n + T - 1) / T;
  const int iblk = blockIdx.x % n_iblk;
  const int t = (blockIdx.x / n_iblk) % nt;
  const int split = blockIdx.x / (n_iblk * nt);
  const int i = iblk * T + threadIdx.x;
  if (i >= n) return;
  const int j_begin = split * chunk;
  const int j_end = min(m, j_begin + chunk);
  const size_t ti = static_cast<size_t>(t) * n + i;
  const float* __restrict__ axi = ax + ti * w0;
  const float* __restrict__ avi = av + ti * w0;
  const float* __restrict__ art = ar + static_cast<size_t>(t) * m * w0;

  float val = 0.0f, hess = 0.0f;
#pragma unroll
  for (int f = 0; f < W; f += 4) st4(acc + f, make_float4(0.0f, 0.0f, 0.0f, 0.0f));

#pragma unroll 1
  for (int j = j_begin; j < j_end; ++j) {
    const float mk = __ldg(mask + j);
    if (mk == 0.0f) continue;  // block-uniform
    const float* __restrict__ arj = art + static_cast<size_t>(j) * w0;
    float z[W], p[W], q[W];
#pragma unroll
    for (int f = 0; f < W; ++f) {
      z[f] = f < w0 ? __ldg(axi + f) - __ldg(arj + f) : 0.0f;
      p[f] = f < w0 ? __ldg(avi + f) : 0.0f;
      q[f] = 0.0f;
    }
#pragma unroll 1
    for (int k = 0; k < L; ++k) k7_layer<W, ACT>(sw + k * (W * W + W), dk0 + k * T * R, z, p, q);

    // head: g = act(z_L) and its streams; M g and M gp
    float g[W], gp[W], gq[W], d1[W];
#pragma unroll
    for (int f = 0; f < W; ++f) {
      float a0, a1, a2, a3;
      act_d<ACT>(z[f], a0, a1, a2, a3);
      g[f] = a0;
      d1[f] = a1;
      gp[f] = a1 * p[f];
      gq[f] = a2 * p[f] * p[f] + a1 * q[f];
    }
    float Mg[W], Mgp[W];
#pragma unroll
    for (int f = 0; f < W; ++f) Mg[f] = Mgp[f] = 0.0f;
#pragma unroll
    for (int r = 0; r < W; ++r) {
#pragma unroll
      for (int c = 0; c < W; c += 4) {
        const float4 w = ld4(sM + r * W + c);
        Mg[c] = fmaf(g[r], w.x, Mg[c]);
        Mg[c + 1] = fmaf(g[r], w.y, Mg[c + 1]);
        Mg[c + 2] = fmaf(g[r], w.z, Mg[c + 2]);
        Mg[c + 3] = fmaf(g[r], w.w, Mg[c + 3]);
        Mgp[c] = fmaf(gp[r], w.x, Mgp[c]);
        Mgp[c + 1] = fmaf(gp[r], w.y, Mgp[c + 1]);
        Mgp[c + 2] = fmaf(gp[r], w.z, Mgp[c + 2]);
        Mgp[c + 3] = fmaf(gp[r], w.w, Mgp[c + 3]);
      }
    }
    float sv = 0.0f, sh = 0.0f, delta[W];
#pragma unroll
    for (int f = 0; f < W; ++f) {
      const float two = 2.0f * Mg[f] + su[f];
      sv += g[f] * (Mg[f] + su[f]);
      sh += 2.0f * gp[f] * Mgp[f] + gq[f] * two;
      delta[f] = two * d1[f];  // dPhi/dz_L
    }
    val += mk * sv;
    hess += mk * sh;

    k7_sweep<W>(sw, dk0, T * R, L, mk, delta, acc);
  }
  k7_write<W>(partials, split, nt, n, w0, ti, val, hess, acc);
}

struct K7Kernel {
  static constexpr bool kOctets = false;
  template <int W, int ACT>
  static constexpr auto get() { return &k7_kernel<W, ACT>; }
};

// f(K::get<W, act>()) for the width and activation, K being K5Kernel,
// K6Kernel, K7Kernel or K8Kernel; other values return cudaErrorInvalidValue
template <typename K, int W, typename F>
cudaError_t with_act(int act, F&& f) {
  switch (act) {
    case kTanh: return f(K::template get<W, kTanh>());
    case kSilu: return f(K::template get<W, kSilu>());
    case kSoftplus: return f(K::template get<W, kSoftplus>());
    default: return cudaErrorInvalidValue;
  }
}

template <typename K, typename F>
cudaError_t with_kernel(int width, int act, F&& f) {
  switch (width) {
    case 8: return with_act<K, 8>(act, f);
    case 16: return with_act<K, 16>(act, f);
    case 20: return with_act<K, 20>(act, f);
    case 24: return with_act<K, 24>(act, f);
    case 32: return with_act<K, 32>(act, f);
    default: break;
  }
  if constexpr (K::kOctets) {  // k6_kernel's eight lanes a pair
    switch (width) {
      case 48: return with_act<K, 48>(act, f);
      case 64: return with_act<K, 64>(act, f);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

// -- K8 ------------------------------------------------------------------------

constexpr int kK8MaxThreads = 256;  // lanes per block, at most: 64 pairs x 4 lanes

// row sets of a K8 block: the saved streams of the layers k = 1 .. L - 1, the
// set H and the set S
__host__ __device__ constexpr int k8_rows(int n_layers) { return (n_layers > 1 ? n_layers : 1) + 1; }

// lanes a pair: four (K8, and k6_kernel at W <= 32) or eight (k6_kernel at
// W = 48 and 64)
__host__ __device__ constexpr int k8_lanes(int w) { return w > 32 ? 8 : 4; }

// floats of one pair's four rows in a row set: 4 k7_row(W) + 4 for four lanes
// a pair, so that the 8 pairs of a warp start 20 banks apart, and 4 k7_row(W)
// + 8 for eight, so that the 4 pairs of a warp start 24 banks apart: either
// way the scalar accesses of a warp hit 32 different banks
__host__ __device__ constexpr int k8_quad(int w, int lanes = 4) {
  return 4 * k7_row(w) + (lanes == 4 ? 4 : 8);
}

// floats of the scratch in which a K8 block's warps leave their weight
// gradients of a layer: two buffers of one layer (w^2 + w) a warp; none for a
// block of one warp, which adds its sums to the accumulators itself
__host__ __device__ constexpr int k8_scratch_floats(int w, int threads) {
  return threads > 32 ? 2 * (threads / 32) * (w * w + w) : 0;
}

size_t k8_shared_bytes(int w, int threads, int n_layers) {
  return sizeof(float) * (2 * static_cast<size_t>(k7_weight_floats(w, n_layers)) +
                          static_cast<size_t>(k8_rows(n_layers)) * (threads / 4) * k8_quad(w) +
                          static_cast<size_t>(k8_scratch_floats(w, threads)) +
                          static_cast<size_t>(threads / 32) * w);
}

// the activation's core: tanh(z) for tanh, of which every derivative is a
// polynomial, else z itself
template <int ACT>
__device__ __forceinline__ float act_core(float z) {
  if constexpr (ACT == kTanh) {
    return tanhf(z);
  } else {
    return z;
  }
}

// (act, act', act'', act''') from the core
template <int ACT>
__device__ __forceinline__ void act_of_core(float c, float& a0, float& a1, float& a2, float& a3) {
  if constexpr (ACT == kTanh) {
    const float d1 = 1.0f - c * c;
    a0 = c;
    a1 = d1;
    a2 = -2.0f * c * d1;
    a3 = d1 * (4.0f * c * c - 2.0f * d1);
  } else {
    act_d<ACT>(c, a0, a1, a2, a3);
  }
}

// Row r of a [W, W] weight block in shared memory holds W's row r with its
// float4 chunk c at chunk c ^ k8_swz(r): 0 for four lanes a pair (the plain
// layout); for eight, a permutation within aligned groups of 4 (W = 48) or 8
// (W = 64) chunks, so that the rows 8 e + s that a pair's eight lanes read at
// once in k8_product_t fall on eight different bank quads (unswizzled, W = 64
// puts all eight on one quad and W = 48 on two).
template <int W, int NL>
__host__ __device__ constexpr int k8_swz(int r) {
  static_assert(NL == 4 || W == 48 || W == 64, "eight lanes a pair at W = 48 or 64 only");
  return NL == 4 ? 0 : (W == 64 ? (r & 7) : ((r >> 1) & 3));
}

// A lane's values v[stream][e] of the features NL e + s into the pair's four
// rows (qrow: the pair's rows of a row set), and the lane's own share of the
// pair's rows (its 4 W / NL values, the streams in order) to and from
// registers.
template <int W, int NL>
__device__ __forceinline__ void k8_to_rows(float* qrow, int s, const float (&v)[4][W / NL]) {
  constexpr int R = k7_row(W);
#pragma unroll
  for (int st = 0; st < 4; ++st) {
#pragma unroll
    for (int e = 0; e < W / NL; ++e) qrow[st * R + NL * e + s] = v[st][e];
  }
}

template <int W, int NL>
__device__ __forceinline__ void k8_save(float* own, const float (&v)[4][W / NL]) {
  constexpr int G = W / NL;
#pragma unroll
  for (int f = 0; f < 4 * G; f += 4) {
    st4(own + f, make_float4(v[f / G][f % G], v[(f + 1) / G][(f + 1) % G], v[(f + 2) / G][(f + 2) % G],
                             v[(f + 3) / G][(f + 3) % G]));
  }
}

template <int W, int NL>
__device__ __forceinline__ void k8_restore(const float* own, float (&v)[4][W / NL]) {
  constexpr int G = W / NL;
#pragma unroll
  for (int f = 0; f < 4 * G; f += 4) {
    const float4 x = ld4(own + f);
    v[f / G][f % G] = x.x;
    v[(f + 1) / G][(f + 1) % G] = x.y;
    v[(f + 2) / G][(f + 2) % G] = x.z;
    v[(f + 3) / G][(f + 3) % G] = x.w;
  }
}

// out[stream][e] = sum_i h_stream[i] Wk[i][NL e + s]: the pair's four
// activated rows read as float4s, each weight used for the four streams
template <int W, int NL>
__device__ __forceinline__ void k8_product(const float* __restrict__ Wk, const float* qrow, int s,
                                           float (&out)[4][W / NL]) {
  constexpr int R = k7_row(W);
  constexpr int G = W / NL;
#pragma unroll
  for (int st = 0; st < 4; ++st) {
#pragma unroll
    for (int e = 0; e < G; ++e) out[st][e] = 0.0f;
  }
#pragma unroll
  for (int i = 0; i < W; i += 4) {
    float h[4][4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const float4 v = ld4(qrow + st * R + i);
      h[st][0] = v.x;
      h[st][1] = v.y;
      h[st][2] = v.z;
      h[st][3] = v.w;
    }
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
      for (int e = 0; e < G; ++e) {
        float w;
        if constexpr (NL == 4) {
          w = Wk[(i + ii) * W + 4 * e + s];
        } else {  // column 8 e + s of a swizzled row: an immediate plus s or s ^ 4
          const int x = 4 * k8_swz<W, NL>(i + ii);  // a constant once the loops unroll
          w = Wk[(i + ii) * W + ((8 * e) ^ (x & ~7)) + (s ^ (x & 4))];
        }
#pragma unroll
        for (int st = 0; st < 4; ++st) out[st][e] = fmaf(h[st][ii], w, out[st][e]);
      }
    }
  }
}

// out[stream][e] = sum_j c_stream[j] Wk[NL e + s][j]: the product with W_k^T
// from W_k's rows, the pair's four cotangent rows read as float4s
template <int W, int NL>
__device__ __forceinline__ void k8_product_t(const float* __restrict__ Wk, const float* qrow, int s,
                                             float (&out)[4][W / NL]) {
  constexpr int R = k7_row(W);
  constexpr int G = W / NL;
  const int fs = k8_swz<W, NL>(s);  // the swizzle of every row NL e + s
#pragma unroll
  for (int st = 0; st < 4; ++st) {
#pragma unroll
    for (int e = 0; e < G; ++e) out[st][e] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < W; j += 4) {
    float4 c[4];
#pragma unroll
    for (int st = 0; st < 4; ++st) c[st] = ld4(qrow + st * R + j);
    const int jo = NL == 4 ? j : 4 * ((j >> 2) ^ fs);
#pragma unroll
    for (int e = 0; e < G; ++e) {
      const float4 w = ld4(Wk + (NL * e + s) * W + jo);
#pragma unroll
      for (int st = 0; st < 4; ++st) {
        out[st][e] = fmaf(c[st].x, w.x, out[st][e]);
        out[st][e] = fmaf(c[st].y, w.y, out[st][e]);
        out[st][e] = fmaf(c[st].z, w.z, out[st][e]);
        out[st][e] = fmaf(c[st].w, w.w, out[st][e]);
      }
    }
  }
}

// The activated streams (h, hp, hq, hr) of one feature from its core and
// raw streams (p, q, r).
__device__ __forceinline__ void k8_mix(float a0, float a1, float a2, float p, float q, float r,
                                       float (&h)[4]) {
  h[0] = a0;
  h[1] = a1 * p;
  h[2] = a2 * p * p + a1 * q;
  h[3] = a1 * r;
}

// The step back through an activation for one feature: from the cotangents y
// of the activated streams, the cotangents of the raw streams (z, p, q, r).
__device__ __forceinline__ void k8_back(float a1, float a2, float a3, float p, float q, float r,
                                        const float (&y)[4], float (&cot)[4]) {
  cot[0] = y[0] * a1 + y[1] * (a2 * p) + y[3] * (a2 * r) + y[2] * (a3 * p * p + a2 * q);
  cot[1] = y[1] * a1 + y[2] * (2.0f * a2 * p);
  cot[2] = y[2] * a1;
  cot[3] = y[3] * a1;
}

// k6_kernel's weight gradients of one layer or chunk, added to the block's
// accumulators gW ([W, W], then the bias's [W]): gW[i][j] += sum over the
// block's rows (pair, stream) of hset[row][i] sset[row][j], and the bias +=
// the sum of sset over the rows of stream `bias_stream`; only the first
// n_prod streams have hset rows other than zero.  A thread owns a BR x 4
// block of gW (BR = 4 at four lanes a pair) and one of S slices of the T / NL
// pairs (S a power of two, S lanes side by side); the slices are summed by
// shuffles in a fixed order and lane 0 of the slices adds to the
// accumulators, which no other thread touches.  (K8 sums per warp first:
// k8_warp_grads.)
template <int W, int NL, int BR>
__device__ __forceinline__ void k8_weight_grads(const float* __restrict__ hset,
                                                const float* __restrict__ sset, float* gW,
                                                int bias_stream, int n_prod, int T, int S) {
  constexpr int R = k7_row(W);
  constexpr int Q = k8_quad(W, NL);
  constexpr int NB1 = W / 4;
  constexpr int NB = (W / BR) * NB1;
  const int slice = threadIdx.x & (S - 1);
  const int groups = T / S;
  const int P = T / NL;
  for (int b0 = 0; b0 < NB; b0 += groups) {
    const int blk = b0 + threadIdx.x / S;
    const bool active = blk < NB;
    const int ib = blk / NB1;
    const int jb = blk - ib * NB1;
    float acc[BR][4], bacc[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) bacc[b] = 0.0f;
#pragma unroll
    for (int a = 0; a < BR; ++a) {
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = 0.0f;
    }
    if (active) {
#pragma unroll 1
      for (int st = 0; st < 4; ++st) {
        const float* hp = hset + st * R + BR * ib;
        const float* sp = sset + st * R + 4 * jb;
        const bool bias = ib == 0 && st == bias_stream;
        if (st >= n_prod && !bias) continue;
#pragma unroll 4
        for (int q = slice; q < P; q += S) {
          float h[BR];
#pragma unroll
          for (int a = 0; a < BR; a += 4) {
            const float4 h4 = ld4(hp + q * Q + a);
            h[a] = h4.x;
            h[a + 1] = h4.y;
            h[a + 2] = h4.z;
            h[a + 3] = h4.w;
          }
          const float4 c4 = ld4(sp + q * Q);
          const float c[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int a = 0; a < BR; ++a) {
#pragma unroll
            for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(h[a], c[b], acc[a][b]);
          }
          if (bias) {
#pragma unroll
            for (int b = 0; b < 4; ++b) bacc[b] += c[b];
          }
        }
      }
    }
    for (int o = S >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int a = 0; a < BR; ++a) {
        if (a < 4) bacc[a] += __shfl_xor_sync(0xffffffffu, bacc[a], o);
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], o);
      }
    }
    if (active && slice == 0) {
#pragma unroll
      for (int a = 0; a < BR; ++a) {
        float* g = gW + (BR * ib + a) * W + 4 * jb;
        float4 v = ld4(g);
        v.x += acc[a][0];
        v.y += acc[a][1];
        v.z += acc[a][2];
        v.w += acc[a][3];
        st4(g, v);
      }
      if (ib == 0) {
        float* g = gW + W * W + 4 * jb;
        float4 v = ld4(g);
        v.x += bacc[0];
        v.y += bacc[1];
        v.z += bacc[2];
        v.w += bacc[3];
        st4(g, v);
      }
    }
  }
}

// K8's weight gradients are summed per warp, then over the warps.  A layer's
// [W, W] gradient is cut into blocks of 4 rows x k8_grad_cols(W) columns
// (8 at W = 24 and 32, else 4), one a lane; at W = 8 and 16 there are fewer
// blocks than lanes, and the lanes that share a block take slices of the
// warp's pairs.  In the block's accumulators and in the scratch a layer's
// gradients are stored blocked: lane b's 4 x BC block as the float4s (a BC
// / 4 + h) NB + b (row a of the block, its float4 h; NB blocks), so that a
// warp's stores and the sums over warps take consecutive float4s; the
// bias's W floats follow, in order.  k8_unblocked maps an entry of K7's
// weight layout to its place there.
template <int W>
__host__ __device__ constexpr int k8_grad_cols() { return W >= 24 ? 8 : 4; }

template <int W>
__device__ __forceinline__ int k8_unblocked(int off) {
  constexpr int BC = k8_grad_cols<W>();
  constexpr int NB = (W / 4) * (W / BC);
  if (off >= W * W) return off;  // the bias
  const int r = off / W, c = off - r * W;
  const int blk = (r / 4) * (W / BC) + c / BC;
  return 4 * (((r % 4) * (BC / 4) + (c % BC) / 4) * NB + blk) + c % 4;
}

// One warp's weight gradients of a layer from its own 8 pairs' rows (hrows,
// srows: the warp's first pair's rows in a row set): sum over the 32 rows
// (pair, stream) of hrows[row][i] srows[row][j], over the streams < NPROD,
// and the bias's sum of srows over the rows of stream BIAS.  Each lane walks
// the rows for its 4 x BC block, reading a float4 of h and BC / 4 float4s of
// c a row, the rows of PB pairs before their FMAs.  Lanes that share a block
// (W = 8, 16) add their slices by shuffles in a fixed order.  The sums go
// blocked (above) to out, a layer's W^2 + W floats, stored, or added where
// `add` (a block of one warp: out is then the accumulators).
template <int W, int NPROD, int BIAS>
__device__ __forceinline__ void k8_warp_grads(const float* __restrict__ hrows,
                                              const float* __restrict__ srows, float* out, bool add) {
  constexpr int R = k7_row(W);
  constexpr int Q = k8_quad(W);
  constexpr int BC = k8_grad_cols<W>();
  constexpr int NBC = W / BC;
  constexpr int NB = (W / 4) * NBC;                 // blocks: 4, 16, 25, 18, 32
  constexpr int RS = 32 % NB == 0 ? 32 / NB : 1;  // lanes a block: 8, 2, else 1
  constexpr int PS = 8 / RS;                       // pairs a slice
  const int lane = threadIdx.x & 31;
  const int blk = lane % NB;
  const int slice = lane / NB;
  const bool active = lane < NB * RS;
  const int ib = blk / NBC;
  const int jb = blk - ib * NBC;
  float acc[4][BC], bacc[BC];
#pragma unroll
  for (int b = 0; b < BC; ++b) {
    bacc[b] = 0.0f;
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a][b] = 0.0f;
  }
  if (active) {
    const float* hp = hrows + slice * PS * Q + 4 * ib;
    const float* sp = srows + slice * PS * Q + BC * jb;
    constexpr int PB = BC == 8 ? 2 : PS;  // pairs whose rows are loaded at once (registers)
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      if (st >= NPROD && st != BIAS) continue;
#pragma unroll
      for (int q0 = 0; q0 < PS; q0 += PB) {
        float4 c4[PB][BC / 4], h4[PB];
#pragma unroll
        for (int q = 0; q < PB; ++q) {
#pragma unroll
          for (int h = 0; h < BC / 4; ++h) c4[q][h] = ld4(sp + (q0 + q) * Q + st * R + 4 * h);
          if (st < NPROD) h4[q] = ld4(hp + (q0 + q) * Q + st * R);
        }
#pragma unroll
        for (int q = 0; q < PB; ++q) {
          float c[BC];
#pragma unroll
          for (int h = 0; h < BC / 4; ++h) {
            c[4 * h] = c4[q][h].x;
            c[4 * h + 1] = c4[q][h].y;
            c[4 * h + 2] = c4[q][h].z;
            c[4 * h + 3] = c4[q][h].w;
          }
          if (st == BIAS) {
#pragma unroll
            for (int b = 0; b < BC; ++b) bacc[b] += c[b];
          }
          if (st < NPROD) {
            const float hv[4] = {h4[q].x, h4[q].y, h4[q].z, h4[q].w};
#pragma unroll
            for (int a = 0; a < 4; ++a) {
#pragma unroll
              for (int b = 0; b < BC; ++b) acc[a][b] = fmaf(hv[a], c[b], acc[a][b]);
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int o = NB; o < NB * RS; o *= 2) {
#pragma unroll
    for (int b = 0; b < BC; ++b) {
      bacc[b] += __shfl_xor_sync(0xffffffffu, bacc[b], o);
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a][b] += __shfl_xor_sync(0xffffffffu, acc[a][b], o);
    }
  }
  if (!active || slice != 0) return;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int h = 0; h < BC / 4; ++h) {
      float* g = out + 4 * ((a * (BC / 4) + h) * NB + blk);
      float4 v = make_float4(acc[a][4 * h], acc[a][4 * h + 1], acc[a][4 * h + 2], acc[a][4 * h + 3]);
      if (add) {
        const float4 o = ld4(g);
        v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
      }
      st4(g, v);
    }
  }
  if (ib == 0) {
#pragma unroll
    for (int h = 0; h < BC / 4; ++h) {
      float* g = out + W * W + BC * jb + 4 * h;
      float4 v = make_float4(bacc[4 * h], bacc[4 * h + 1], bacc[4 * h + 2], bacc[4 * h + 3]);
      if (add) {
        const float4 o = ld4(g);
        v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
      }
      st4(g, v);
    }
  }
}

// The warps' sums of a layer (scr: nw rows of W^2 + W floats, blocked) are
// added in warp order to the block's accumulators of that layer: warp w takes
// the float4 columns [w C, (w + 1) C), C = ceil(columns / nw), one a lane, so
// that every warp does a like share; no two threads touch one column.
// k8_load_column loads column c of every warp, k8_add_column adds them (in
// warp order) to the accumulators' float4 at g.
constexpr int kK8MaxWarps = kK8MaxThreads / 32;

template <int W>
__device__ __forceinline__ void k8_load_column(const float* __restrict__ scr, int nw, int c,
                                               float4 (&v)[kK8MaxWarps]) {
  constexpr int C4 = (W * W + W) / 4;
#pragma unroll
  for (int w = 0; w < kK8MaxWarps; ++w) {
    if (w < nw) v[w] = ld4(scr + 4 * (w * C4 + c));
  }
}

__device__ __forceinline__ void k8_add_column(const float4 (&v)[kK8MaxWarps], int nw, float* g) {
  float4 s = v[0];
#pragma unroll
  for (int w = 1; w < kK8MaxWarps; ++w) {
    if (w < nw) s = make_float4(s.x + v[w].x, s.y + v[w].y, s.z + v[w].z, s.w + v[w].w);
  }
  const float4 o = ld4(g);
  st4(g, make_float4(o.x + s.x, o.y + s.y, o.z + s.z, o.w + s.w));
}

template <int W>
__device__ __forceinline__ void k8_add_warps(const float* __restrict__ scr, int nw, float* g) {
  constexpr int C4 = (W * W + W) / 4;
  const int per = (C4 + nw - 1) / nw;
  const int warp = threadIdx.x >> 5;
  const int end = min(C4, (warp + 1) * per);
  for (int c = warp * per + (threadIdx.x & 31); c < end; c += 32) {
    float4 v[kK8MaxWarps];
    k8_load_column<W>(scr, nw, c, v);
    k8_add_column(v, nw, g + 4 * c);
  }
}

// K8: the VJP of K7 (see the header).  weights: K7's zero-padded buffer;
// w_partials: one row of the same layout per block; x_partials: [n_split, 2,
// nt, n, w0]; ar_partials: [ceil(n / (threads / 4)), nt, m, w0].
template <int W, int ACT>
__global__ void __launch_bounds__(kK8MaxThreads)
    k8_kernel(int n_layers, int w0, int nt, int n, int m, int chunk, const float* __restrict__ ax,
              const float* __restrict__ av, const float* __restrict__ ar,
              const float* __restrict__ mask, const float* __restrict__ g_val,
              const float* __restrict__ g_hess, const float* __restrict__ g_dz0,
              const float* __restrict__ weights, float* __restrict__ w_partials,
              float* __restrict__ x_partials, float* __restrict__ ar_partials) {
  extern __shared__ float4 smem4[];
  constexpr int R = k7_row(W);
  constexpr int Q = k8_quad(W);
  constexpr int G = W / 4;       // features per lane: 4 e + s
  constexpr int LW = W * W + W;  // floats of one layer's weights and bias
  const int L = n_layers;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int P = T / 4;  // pairs (points) per block
  const int n_wf = k7_weight_floats(W, L);
  float* sw = reinterpret_cast<float*>(smem4);
  float* gacc = sw + n_wf;
  float* sets = gacc + n_wf;
  const int n_sets = k8_rows(L);
  const int nw = T / 32;  // warps
  float* scratch = sets + n_sets * P * Q;  // buffer b, warp w at scratch + (b nw + w) LW
  float* arw = scratch + k8_scratch_floats(W, T);
  for (int idx = tid; idx < n_wf / 4; idx += T) {
    smem4[idx] = __ldg(reinterpret_cast<const float4*>(weights) + idx);
    smem4[n_wf / 4 + idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float* sM = sw + L * LW;
  const float* su = sM + W * W;
  // row sets: saved layer k at k - 1 (k = 1 .. L - 1), then H, S
  float* setH = sets + (n_sets - 2) * P * Q;
  float* setS = sets + (n_sets - 1) * P * Q;

  const int lane = tid & 31;
  const int wrows = (tid >> 5) * 8 * Q;  // the warp's 8 pairs' rows in a row set
  // The weight gradients of a grads point g (the head, g = L, or layer g):
  // `product` leaves the warp's sums in its row of scratch buffer `buf` (in a
  // block of one warp, adds them to the accumulators), and the sums of the
  // point before (pend, in the other buffer) are added over the warps
  // meanwhile.  Where a thread has one column of them and the registers allow
  // (W <= 20), it loads the column before the product and adds it after, so
  // that the loads wait behind the product's FMAs.  The buffers alternate
  // from point to point, so one barrier a point suffices.
  constexpr int C4 = LW / 4;
  const int per = (C4 + nw - 1) / nw;
  const int col = (tid >> 5) * per + lane;  // the thread's first column
  const bool has_col = col < min(C4, ((tid >> 5) + 1) * per);
  int pend = -1, buf = 0;
  auto grads = [&](int g, auto product) {
    const float* prev = scratch + (buf ^ 1) * nw * LW;
    const bool early = W <= 20 && per <= 32 && pend >= 0;
    float4 v[kK8MaxWarps];
    if (early && has_col) k8_load_column<W>(prev, nw, col, v);
    product(nw > 1 ? scratch + (buf * nw + (tid >> 5)) * LW : gacc + g * LW);
    if (early) {
      if (has_col) k8_add_column(v, nw, gacc + pend * LW + 4 * col);
    } else if (pend >= 0) {
      k8_add_warps<W>(prev, nw, gacc + pend * LW);
    }
    __syncthreads();
    if (nw > 1) {
      pend = g;
      buf ^= 1;
    }
  };
  const int s = tid & 3;             // this lane's features: 4 e + s
  const int qoff = (tid >> 2) * Q;   // the pair's rows in a row set
  const int own = qoff + s * R;      // the lane's own row there
  const int n_iblk = (n + P - 1) / P;
  const int iblk = blockIdx.x % n_iblk;
  const int t = (blockIdx.x / n_iblk) % nt;
  const int split = blockIdx.x / (n_iblk * nt);
  const int i = iblk * P + (tid >> 2);
  const bool valid = i < n;
  const int j_begin = split * chunk;
  const int j_end = min(m, j_begin + chunk);
  const size_t ti = static_cast<size_t>(t) * n + (valid ? i : 0);
  const float* __restrict__ art = ar + static_cast<size_t>(t) * m * w0;

  // the point's layer-0 streams at the lane's features, and its sums
  float bz[G], bp[G], br[G], sumz[G], sump[G];
#pragma unroll
  for (int e = 0; e < G; ++e) {
    const int f = 4 * e + s;
    const bool in = valid && f < w0;
    bz[e] = in ? __ldg(ax + ti * w0 + f) : 0.0f;
    bp[e] = in ? __ldg(av + ti * w0 + f) : 0.0f;
    br[e] = in ? __ldg(g_dz0 + ti * w0 + f) : 0.0f;
    sumz[e] = sump[e] = 0.0f;
  }
  const float gv = valid ? __ldg(g_val + ti) : 0.0f;
  const float gh = valid ? __ldg(g_hess + ti) : 0.0f;
  __syncthreads();

#pragma unroll 1
  for (int j = j_begin; j < j_end; ++j) {
    const float mk = __ldg(mask + j);
    float* __restrict__ ar_row = ar_partials + ((static_cast<size_t>(iblk) * nt + t) * m + j) * w0;
    if (mk == 0.0f) {  // block-uniform: this ref adds nothing
      if (tid < w0) ar_row[tid] = 0.0f;
      continue;
    }
    const float cm = valid ? mk : 0.0f;
    const float* __restrict__ arj = art + static_cast<size_t>(j) * w0;
    float x[4][G];  // the raw streams z, p, q, r
#pragma unroll
    for (int e = 0; e < G; ++e) {
      x[0][e] = bz[e] - (4 * e + s < w0 ? __ldg(arj + 4 * e + s) : 0.0f);
      x[1][e] = bp[e];
      x[2][e] = 0.0f;
      x[3][e] = br[e];
    }

    // forward; layer k's raw inputs are saved for k >= 1 (the core for z)
#pragma unroll 1
    for (int k = 0; k < L; ++k) {
      float h[4][G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        x[0][e] = act_core<ACT>(x[0][e]);
        float a0, a1, a2, a3, he[4];
        act_of_core<ACT>(x[0][e], a0, a1, a2, a3);
        k8_mix(a0, a1, a2, x[1][e], x[2][e], x[3][e], he);
#pragma unroll
        for (int st = 0; st < 4; ++st) h[st][e] = he[st];
      }
      if (k > 0) k8_save<W, 4>(sets + (k - 1) * P * Q + own, x);
      __syncwarp();  // the pair's lanes have read H for the layer before
      k8_to_rows<W, 4>(setH + qoff, s, h);
      __syncwarp();
      const float* Wk = sw + k * LW;
      k8_product<W, 4>(Wk, setH + qoff, s, x);
#pragma unroll
      for (int e = 0; e < G; ++e) x[0][e] += Wk[W * W + 4 * e + s];
    }

    // head: g's streams, their products with M, the cotangents of z_L and
    // the rows of M's and u's gradients (H: L1 | 2 gh gp | 0 | 0, S: g | gp |
    // u's | 0)
    float cot[4][G];
    {
      float hs[4][G], core[G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        core[e] = act_core<ACT>(x[0][e]);
        float a0, a1, a2, a3, he[4];
        act_of_core<ACT>(core[e], a0, a1, a2, a3);
        k8_mix(a0, a1, a2, x[1][e], x[2][e], x[3][e], he);
#pragma unroll
        for (int st = 0; st < 4; ++st) hs[st][e] = he[st];
      }
      __syncwarp();
      k8_to_rows<W, 4>(setH + qoff, s, hs);
      __syncwarp();
      float Mh[4][G];
      k8_product<W, 4>(sM, setH + qoff, s, Mh);
      float hr[4][G], sr[4][G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        const float two = 2.0f * Mh[0][e] + su[4 * e + s];
        const float y[4] = {cm * (gv * two + 2.0f * gh * Mh[2][e] + 2.0f * Mh[3][e]),
                            cm * (4.0f * gh * Mh[1][e]), cm * (gh * two), cm * two};
        const float A = gv * hs[0][e];
        const float B = gh * hs[2][e] + hs[3][e];
        hr[0][e] = cm * (A + 2.0f * B);
        hr[1][e] = cm * (2.0f * gh * hs[1][e]);
        hr[2][e] = hr[3][e] = 0.0f;
        sr[0][e] = hs[0][e];
        sr[1][e] = hs[1][e];
        sr[2][e] = cm * (A + B);
        sr[3][e] = 0.0f;
        float a0, a1, a2, a3, ce[4];
        act_of_core<ACT>(core[e], a0, a1, a2, a3);
        k8_back(a1, a2, a3, x[1][e], x[2][e], x[3][e], y, ce);
#pragma unroll
        for (int st = 0; st < 4; ++st) cot[st][e] = ce[st];
      }
      __syncwarp();  // the warp's lanes have read H and S
      k8_to_rows<W, 4>(setH + qoff, s, hr);
      k8_to_rows<W, 4>(setS + qoff, s, sr);
      __syncwarp();
      grads(L, [&](float* out) { k8_warp_grads<W, 2, 2>(setH + wrows, setS + wrows, out, nw == 1); });
    }

    // reverse sweep: cot is the cotangent of layer k's outputs
#pragma unroll 1
    for (int k = L - 1; k >= 0; --k) {
      k8_to_rows<W, 4>(setS + qoff, s, cot);  // the warp read S before the last barrier
      __syncwarp();
      float hb[4][G];
      k8_product_t<W, 4>(sw + k * LW, setS + qoff, s, hb);
      float* hk = k == 0 ? setH : sets + (k - 1) * P * Q;
      if (k == 0) {  // layer 0's inputs are not saved
#pragma unroll
        for (int e = 0; e < G; ++e) {
          x[0][e] = act_core<ACT>(bz[e] - (4 * e + s < w0 ? __ldg(arj + 4 * e + s) : 0.0f));
          x[1][e] = bp[e];
          x[2][e] = 0.0f;
          x[3][e] = br[e];
        }
      } else {
        k8_restore<W, 4>(hk + own, x);
      }
      float h[4][G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        float a0, a1, a2, a3, he[4], ce[4];
        act_of_core<ACT>(x[0][e], a0, a1, a2, a3);
        const float y[4] = {hb[0][e], hb[1][e], hb[2][e], hb[3][e]};
        k8_back(a1, a2, a3, x[1][e], x[2][e], x[3][e], y, ce);
        k8_mix(a0, a1, a2, x[1][e], x[2][e], x[3][e], he);
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          cot[st][e] = ce[st];
          h[st][e] = he[st];
        }
      }
      __syncwarp();  // the warp's lanes have read their saved rows (and H)
      k8_to_rows<W, 4>(hk + qoff, s, h);
      __syncwarp();
      grads(k, [&](float* out) { k8_warp_grads<W, 4, 0>(hk + wrows, setS + wrows, out, nw == 1); });
    }

    // cot is (z0bar | p0bar | q0bar | r0bar): the point's sums, and the ref's
    // row summed over the block's points
#pragma unroll
    for (int e = 0; e < G; ++e) {
      sumz[e] += cot[0][e];
      sump[e] += cot[1][e];
      float v = cot[0][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) arw[(tid >> 5) * W + 4 * e + s] = v;
    }
    __syncthreads();
    if (tid < w0) {
      float v = 0.0f;
      for (int w = 0; w < T / 32; ++w) v += arw[w * W + tid];
      ar_row[tid] = -v;
    }
  }

  // the last point's sums over the warps; this split's ax and av cotangents,
  // each [nt, n, w0], and the block's row of weight gradients
  if (pend >= 0) k8_add_warps<W>(scratch + (buf ^ 1) * nw * LW, nw, gacc + pend * LW);
  if (valid) {
    const size_t tnw = static_cast<size_t>(nt) * n * w0;
    float* o = x_partials + static_cast<size_t>(split) * 2 * tnw + ti * w0;
#pragma unroll
    for (int e = 0; e < G; ++e) {
      if (4 * e + s < w0) {
        o[4 * e + s] = sumz[e];
        o[tnw + 4 * e + s] = sump[e];
      }
    }
  }
  __syncthreads();
  float* __restrict__ part = w_partials + static_cast<size_t>(blockIdx.x) * n_wf;
  for (int e = tid; e < n_wf; e += T) {
    const int k = e / LW;
    part[e] = gacc[k * LW + k8_unblocked<W>(e - k * LW)];
  }
}

struct K8Kernel {
  static constexpr bool kOctets = false;
  template <int W, int ACT>
  static constexpr auto get() { return &k8_kernel<W, ACT>; }
};

// -- K6 on K8's lane quads (W <= 32) and lane octets (W = 48, 64) ------------------

constexpr int kK6MaxThreads = 256;  // lanes per block, at most
// rows of the blocks of a layer's weight gradient that a thread owns in
// k8_weight_grads at eight lanes a pair (4 at four lanes): 8 x 4 blocks ran
// faster than 4 x 4 in every turn at 64 -> 64 -> 128
constexpr int kK6OctetGradRows = 8;

// floats of K6's weights: n_layers x (W_k [W, W], b_k [W]) and the feature
// layer as n_chunks chunks of W features, each a [W, W] block of W_F's
// columns and its W biases: (n_layers + n_chunks) (W^2 + W)
__host__ __device__ constexpr int k6_weight_floats(int w, int n_layers, int n_chunks) {
  return (n_layers + n_chunks) * (w * w + w);
}

// row sets of a k6_kernel block: the saved streams of the layers k = 1 .. L -
// 1, the set H and the two sets S
__host__ __device__ constexpr int k6_rows(int n_layers) { return (n_layers > 1 ? n_layers : 1) + 2; }

size_t k6_shared_bytes(int w, int threads, int n_layers, int n_chunks) {
  const int lanes = k8_lanes(w);
  return sizeof(float) * (2 * static_cast<size_t>(k6_weight_floats(w, n_layers, n_chunks)) +
                          static_cast<size_t>(k6_rows(n_layers)) * (threads / lanes) * k8_quad(w, lanes) +
                          static_cast<size_t>(threads / 32) * w);
}

// K6: the VJP of K5 for hidden widths <= 64 (see the header), NL = 4 lanes a
// pair at W <= 32 and 8 at W = 48, 64.  weights: the zero-padded [L x (W_k,
// b_k), n_chunks x (W_F chunk, b_F chunk)]; w_partials: one row of that
// layout per block; x_partials: [n_split, 2, nt, n, w0]; ar_partials:
// [ceil(n / (threads / NL)), nt, m, w0].
template <int W, int ACT>
__global__ void __launch_bounds__(kK6MaxThreads)
    k6_kernel(int n_layers, int n_chunks, int w0, int nt, int n, int m, int chunk,
              const float* __restrict__ ax, const float* __restrict__ av, const float* __restrict__ ar,
              const float* __restrict__ mask, const float* __restrict__ g_val,
              const float* __restrict__ g_hess, const float* __restrict__ g_dz0,
              const float* __restrict__ weights, float* __restrict__ w_partials,
              float* __restrict__ x_partials, float* __restrict__ ar_partials) {
  extern __shared__ float4 smem4[];
  constexpr int NL = k8_lanes(W);  // lanes a pair
  constexpr int LOG_NL = NL == 4 ? 2 : 3;
  constexpr int BR = NL == 4 ? 4 : kK6OctetGradRows;
  constexpr int R = k7_row(W);
  constexpr int Q = k8_quad(W, NL);
  constexpr int G = W / NL;      // features per lane: NL e + s
  constexpr int LW = W * W + W;  // floats of one layer's (or chunk's) weights and bias
  const int L = n_layers;
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const int P = T / NL;  // pairs (points) per block
  const int n_wf = k6_weight_floats(W, L, n_chunks);
  float* sw = reinterpret_cast<float*>(smem4);
  float* gacc = sw + n_wf;
  float* sets = gacc + n_wf;
  const int n_sets = k6_rows(L);
  float* arw = sets + n_sets * P * Q;
  for (int idx = tid; idx < n_wf / 4; idx += T) {
    int at = idx;  // where the float4 goes: the [W, W] blocks' rows swizzled (k8_swz)
    if constexpr (NL == 8) {
      const int layer = idx / (LW / 4), off = idx - layer * (LW / 4);
      if (off < W * W / 4) {
        const int r = off / (W / 4), c = off - r * (W / 4);
        at = layer * (LW / 4) + r * (W / 4) + (c ^ k8_swz<W, NL>(r));
      }
    }
    smem4[at] = __ldg(reinterpret_cast<const float4*>(weights) + idx);
    smem4[n_wf / 4 + idx] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  const float* sF = sw + L * LW;  // chunk c of the feature layer at sF + c LW
  // row sets: saved layer k at k - 1 (k = 1 .. L - 1), then H, S[0], S[1]
  float* setH = sets + (n_sets - 3) * P * Q;
  float* setS = sets + (n_sets - 2) * P * Q;  // S[b] at setS + b P Q
  int S = 1;  // pair slices of the weight-gradient product
  while (2 * S <= 32 && 2 * S * (W / BR) * (W / 4) <= T) S *= 2;

  const int lane = tid & 31;
  const int s = tid & (NL - 1);       // this lane's features: NL e + s
  const int qoff = (tid >> LOG_NL) * Q;  // the pair's rows in a row set
  // the lane's own share there, 4 G floats: row s (four lanes), half of row
  // s / 2 (eight lanes)
  const int own = qoff + (NL == 4 ? s * R : (s >> 1) * R + (s & 1) * 4 * G);
  const int n_iblk = (n + P - 1) / P;
  const int iblk = blockIdx.x % n_iblk;
  const int t = (blockIdx.x / n_iblk) % nt;
  const int split = blockIdx.x / (n_iblk * nt);
  const int i = iblk * P + (tid >> LOG_NL);
  const bool valid = i < n;
  const int j_begin = split * chunk;
  const int j_end = min(m, j_begin + chunk);
  const size_t ti = static_cast<size_t>(t) * n + (valid ? i : 0);
  const float* __restrict__ art = ar + static_cast<size_t>(t) * m * w0;

  // the point's layer-0 streams at the lane's features, and its sums
  float bz[G], bp[G], br[G], sumz[G], sump[G];
#pragma unroll
  for (int e = 0; e < G; ++e) {
    const int f = NL * e + s;
    const bool in = valid && f < w0;
    bz[e] = in ? __ldg(ax + ti * w0 + f) : 0.0f;
    bp[e] = in ? __ldg(av + ti * w0 + f) : 0.0f;
    br[e] = in ? __ldg(g_dz0 + ti * w0 + f) : 0.0f;
    sumz[e] = sump[e] = 0.0f;
  }
  const float gv = valid ? __ldg(g_val + ti) : 0.0f;
  const float gh = valid ? __ldg(g_hess + ti) : 0.0f;
  __syncthreads();

#pragma unroll 1
  for (int j = j_begin; j < j_end; ++j) {
    const float mk = __ldg(mask + j);
    float* __restrict__ ar_row = ar_partials + ((static_cast<size_t>(iblk) * nt + t) * m + j) * w0;
    if (mk == 0.0f) {  // block-uniform: this ref adds nothing
      if (tid < w0) ar_row[tid] = 0.0f;
      if constexpr (W > 32) {  // w0 <= W <= 2 T: a lane may own a second entry
        if (tid + T < w0) ar_row[tid + T] = 0.0f;
      }
      continue;
    }
    const float cm = valid ? mk : 0.0f;
    const float* __restrict__ arj = art + static_cast<size_t>(j) * w0;
    float x[4][G];  // the raw streams z, p, q, r
#pragma unroll
    for (int e = 0; e < G; ++e) {
      x[0][e] = bz[e] - (NL * e + s < w0 ? __ldg(arj + NL * e + s) : 0.0f);
      x[1][e] = bp[e];
      x[2][e] = 0.0f;
      x[3][e] = br[e];
    }

    // forward through the hidden layers, as K8; layer k's raw inputs are
    // saved for k >= 1 (the core for z)
#pragma unroll 1
    for (int k = 0; k < L; ++k) {
      float h[4][G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        x[0][e] = act_core<ACT>(x[0][e]);
        float a0, a1, a2, a3, he[4];
        act_of_core<ACT>(x[0][e], a0, a1, a2, a3);
        k8_mix(a0, a1, a2, x[1][e], x[2][e], x[3][e], he);
#pragma unroll
        for (int st = 0; st < 4; ++st) h[st][e] = he[st];
      }
      if (k > 0) k8_save<W, NL>(sets + (k - 1) * P * Q + own, x);
      __syncwarp();  // the pair's lanes have read H for the layer before
      k8_to_rows<W, NL>(setH + qoff, s, h);
      __syncwarp();
      const float* Wk = sw + k * LW;
      k8_product<W, NL>(Wk, setH + qoff, s, x);
#pragma unroll
      for (int e = 0; e < G; ++e) x[0][e] += Wk[W * W + NL * e + s];
    }

    // the square head, streamed: layer L's activated streams stay in H; each
    // chunk of W features gives the chunk's (z, p, q, r)_F, their cotangents
    // (into S[c & 1]), their share of hbar (in registers) and of the chunk's
    // W_F and b_F gradients
    float cot[4][G];
    {
      float hs[4][G], core[G], hb[4][G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        core[e] = act_core<ACT>(x[0][e]);
        float a0, a1, a2, a3, he[4];
        act_of_core<ACT>(core[e], a0, a1, a2, a3);
        k8_mix(a0, a1, a2, x[1][e], x[2][e], x[3][e], he);
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          hs[st][e] = he[st];
          hb[st][e] = 0.0f;
        }
      }
      __syncwarp();
      k8_to_rows<W, NL>(setH + qoff, s, hs);
      __syncwarp();
#pragma unroll 1
      for (int c = 0; c < n_chunks; ++c) {
        const float* Wc = sF + c * LW;
        float y[4][G];
        k8_product<W, NL>(Wc, setH + qoff, s, y);
#pragma unroll
        for (int e = 0; e < G; ++e) {
          const float z = y[0][e] + Wc[W * W + NL * e + s];
          const float pp = y[1][e], q = y[2][e], r = y[3][e];
          y[0][e] = cm * (2.0f * gv * z + 2.0f * gh * q + 2.0f * r);
          y[1][e] = cm * (4.0f * gh * pp);
          y[2][e] = cm * (2.0f * gh * z);
          y[3][e] = cm * (2.0f * z);
        }
        float* sc = setS + (c & 1) * P * Q;
        k8_to_rows<W, NL>(sc + qoff, s, y);
        __syncwarp();
        float part[4][G];
        k8_product_t<W, NL>(Wc, sc + qoff, s, part);
#pragma unroll
        for (int st = 0; st < 4; ++st) {
#pragma unroll
          for (int e = 0; e < G; ++e) hb[st][e] += part[st][e];
        }
        __syncthreads();
        k8_weight_grads<W, NL, BR>(setH, sc, gacc + (L + c) * LW, 0, 4, T, S);
      }
#pragma unroll
      for (int e = 0; e < G; ++e) {
        float a0, a1, a2, a3, ce[4];
        act_of_core<ACT>(core[e], a0, a1, a2, a3);
        const float y[4] = {hb[0][e], hb[1][e], hb[2][e], hb[3][e]};
        k8_back(a1, a2, a3, x[1][e], x[2][e], x[3][e], y, ce);
#pragma unroll
        for (int st = 0; st < 4; ++st) cot[st][e] = ce[st];
      }
      __syncthreads();  // every warp is done with the head's rows in H and S
    }

    // reverse sweep through the hidden layers, as K8: cot is the cotangent
    // of layer k's outputs
#pragma unroll 1
    for (int k = L - 1; k >= 0; --k) {
      float* sk = setS + (k & 1) * P * Q;
      k8_to_rows<W, NL>(sk + qoff, s, cot);
      __syncwarp();
      float hb[4][G];
      k8_product_t<W, NL>(sw + k * LW, sk + qoff, s, hb);
      float* hk = k == 0 ? setH : sets + (k - 1) * P * Q;
      if (k == 0) {  // layer 0's inputs are not saved
#pragma unroll
        for (int e = 0; e < G; ++e) {
          x[0][e] = act_core<ACT>(bz[e] - (NL * e + s < w0 ? __ldg(arj + NL * e + s) : 0.0f));
          x[1][e] = bp[e];
          x[2][e] = 0.0f;
          x[3][e] = br[e];
        }
      } else {
        k8_restore<W, NL>(hk + own, x);
      }
      float h[4][G];
#pragma unroll
      for (int e = 0; e < G; ++e) {
        float a0, a1, a2, a3, he[4], ce[4];
        act_of_core<ACT>(x[0][e], a0, a1, a2, a3);
        const float y[4] = {hb[0][e], hb[1][e], hb[2][e], hb[3][e]};
        k8_back(a1, a2, a3, x[1][e], x[2][e], x[3][e], y, ce);
        k8_mix(a0, a1, a2, x[1][e], x[2][e], x[3][e], he);
#pragma unroll
        for (int st = 0; st < 4; ++st) {
          cot[st][e] = ce[st];
          h[st][e] = he[st];
        }
      }
      __syncwarp();  // the pair's lanes have read their saved rows
      k8_to_rows<W, NL>(hk + qoff, s, h);
      __syncthreads();
      k8_weight_grads<W, NL, BR>(hk, sk, gacc + k * LW, 0, 4, T, S);
    }

    // cot is (z0bar | p0bar | q0bar | r0bar): the point's sums, and the ref's
    // row summed over the block's points
#pragma unroll
    for (int e = 0; e < G; ++e) {
      sumz[e] += cot[0][e];
      sump[e] += cot[1][e];
      float v = cot[0][e];
      if constexpr (NL == 4) v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < NL) arw[(tid >> 5) * W + NL * e + s] = v;
    }
    __syncthreads();
    if (tid < w0) {
      float v = 0.0f;
      for (int w = 0; w < T / 32; ++w) v += arw[w * W + tid];
      ar_row[tid] = -v;
    }
    if constexpr (W > 32) {
      if (tid + T < w0) {
        float v = 0.0f;
        for (int w = 0; w < T / 32; ++w) v += arw[w * W + tid + T];
        ar_row[tid + T] = -v;
      }
    }
  }

  // this split's ax and av cotangents, each [nt, n, w0], and the block's row
  // of weight gradients
  if (valid) {
    const size_t tnw = static_cast<size_t>(nt) * n * w0;
    float* o = x_partials + static_cast<size_t>(split) * 2 * tnw + ti * w0;
#pragma unroll
    for (int e = 0; e < G; ++e) {
      if (NL * e + s < w0) {
        o[NL * e + s] = sumz[e];
        o[tnw + NL * e + s] = sump[e];
      }
    }
  }
  __syncthreads();
  float* __restrict__ part = w_partials + static_cast<size_t>(blockIdx.x) * n_wf;
  for (int e = tid; e < n_wf; e += T) part[e] = gacc[e];
}

struct K6Kernel {
  static constexpr bool kOctets = true;  // also W = 48 and 64
  template <int W, int ACT>
  static constexpr auto get() { return &k6_kernel<W, ACT>; }
};

// -- K5 on K7's thread per point --------------------------------------------------

constexpr int kK5MaxThreads = 128;  // points per block, at most
constexpr int kK5Chunk = 4;         // features of the feature layer a chunk

// floats of K5's weights: n_layers x (W_k [W, W], b_k [W]), then W_F [W, F4]
// row-major and b_F [F4], F4 = kK5Chunk n_chunks
__host__ __device__ constexpr int k5_weight_floats(int w, int n_layers, int n_chunks) {
  return n_layers * (w * w + w) + (w + 1) * kK5Chunk * n_chunks;
}

size_t k5_shared_bytes(int w, int threads, int n_layers, int n_chunks) {
  return sizeof(float) * (static_cast<size_t>(k5_weight_floats(w, n_layers, n_chunks)) +
                          static_cast<size_t>(n_layers + 1) * threads * k7_row(w));
}

// K5: for the point (t, i) of this thread and the refs of this block's
// split, value, hess and s_dz0 into the split's partial row (see the header).
// weights: the zero-padded [L x (W_k [W, W], b_k [W]), W_F [W, F4], b_F [F4]].
template <int W, int ACT>
__global__ void __launch_bounds__(kK5MaxThreads)
    k5_kernel(int n_layers, int n_chunks, int w0, int nt, int n, int m, int chunk,
              const float* __restrict__ ax, const float* __restrict__ av, const float* __restrict__ ar,
              const float* __restrict__ mask, const float* __restrict__ weights,
              float* __restrict__ partials) {
  extern __shared__ float4 smem4[];
  const int L = n_layers;
  const int T = blockDim.x;
  const int F4 = kK5Chunk * n_chunks;
  const int n_w4 = k5_weight_floats(W, L, n_chunks) / 4;  // W and F4 are multiples of 4
  for (int idx = threadIdx.x; idx < n_w4; idx += T) {
    smem4[idx] = __ldg(reinterpret_cast<const float4*>(weights) + idx);
  }
  __syncthreads();
  const float* sw = reinterpret_cast<const float*>(smem4);
  const float* sF = sw + L * (W * W + W);  // W_F, row i at sF + i F4
  const float* sbF = sF + W * F4;
  // this thread's rows: act'(z_k) at dk0 + k T R, its s_dz0 sums at acc
  constexpr int R = k7_row(W);
  float* dk0 = reinterpret_cast<float*>(smem4 + n_w4) + threadIdx.x * R;
  float* acc = dk0 + L * T * R;

  const int n_iblk = (n + T - 1) / T;
  const int iblk = blockIdx.x % n_iblk;
  const int t = (blockIdx.x / n_iblk) % nt;
  const int split = blockIdx.x / (n_iblk * nt);
  const int i = iblk * T + threadIdx.x;
  if (i >= n) return;
  const int j_begin = split * chunk;
  const int j_end = min(m, j_begin + chunk);
  const size_t ti = static_cast<size_t>(t) * n + i;
  const float* __restrict__ axi = ax + ti * w0;
  const float* __restrict__ avi = av + ti * w0;
  const float* __restrict__ art = ar + static_cast<size_t>(t) * m * w0;

  float val = 0.0f, hess = 0.0f;
#pragma unroll
  for (int f = 0; f < W; f += 4) st4(acc + f, make_float4(0.0f, 0.0f, 0.0f, 0.0f));

#pragma unroll 1
  for (int j = j_begin; j < j_end; ++j) {
    const float mk = __ldg(mask + j);
    if (mk == 0.0f) continue;  // block-uniform
    const float* __restrict__ arj = art + static_cast<size_t>(j) * w0;
    float z[W], p[W], q[W];
#pragma unroll
    for (int f = 0; f < W; ++f) {
      z[f] = f < w0 ? __ldg(axi + f) - __ldg(arj + f) : 0.0f;
      p[f] = f < w0 ? __ldg(avi + f) : 0.0f;
      q[f] = 0.0f;
    }
#pragma unroll 1
    for (int k = 0; k < L; ++k) k7_layer<W, ACT>(sw + k * (W * W + W), dk0 + k * T * R, z, p, q);

    // head: layer L's streams activated in place, act'(z_L) kept in d1
    float d1[W], hbar[W];
#pragma unroll
    for (int f = 0; f < W; ++f) {
      float a0, a2, a3;
      act_d<ACT>(z[f], a0, d1[f], a2, a3);
      const float pf = p[f];
      z[f] = a0;
      p[f] = d1[f] * pf;
      q[f] = a2 * pf * pf + d1[f] * q[f];
      hbar[f] = 0.0f;
    }
    // the feature layer in chunks of 4 features: their (z, p, q)_F, their
    // share of value and hess, and of hbar = dPhi/d act(z_L) = 2 z_F W_F^T
    float sv = 0.0f, sh = 0.0f;
#pragma unroll 1
    for (int c = 0; c < F4; c += kK5Chunk) {
      float zc[4] = {0.0f, 0.0f, 0.0f, 0.0f}, pc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float qc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const float4 w = ld4(sF + r * F4 + c);
        zc[0] = fmaf(z[r], w.x, zc[0]);
        zc[1] = fmaf(z[r], w.y, zc[1]);
        zc[2] = fmaf(z[r], w.z, zc[2]);
        zc[3] = fmaf(z[r], w.w, zc[3]);
        pc[0] = fmaf(p[r], w.x, pc[0]);
        pc[1] = fmaf(p[r], w.y, pc[1]);
        pc[2] = fmaf(p[r], w.z, pc[2]);
        pc[3] = fmaf(p[r], w.w, pc[3]);
        qc[0] = fmaf(q[r], w.x, qc[0]);
        qc[1] = fmaf(q[r], w.y, qc[1]);
        qc[2] = fmaf(q[r], w.z, qc[2]);
        qc[3] = fmaf(q[r], w.w, qc[3]);
      }
      const float4 b = ld4(sbF + c);
      zc[0] += b.x;
      zc[1] += b.y;
      zc[2] += b.z;
      zc[3] += b.w;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sv = fmaf(zc[e], zc[e], sv);
        sh = fmaf(pc[e], pc[e], sh);
        sh = fmaf(zc[e], qc[e], sh);
        zc[e] *= 2.0f;  // dPhi/dz_F
      }
#pragma unroll
      for (int r = 0; r < W; ++r) {
        const float4 w = ld4(sF + r * F4 + c);
        float s = hbar[r];
        s = fmaf(zc[0], w.x, s);
        s = fmaf(zc[1], w.y, s);
        s = fmaf(zc[2], w.z, s);
        s = fmaf(zc[3], w.w, s);
        hbar[r] = s;
      }
    }
    val += mk * sv;
    hess += mk * (2.0f * sh);

    // reverse sweep, as K7's, from delta = dPhi/dz_L
    float delta[W];
#pragma unroll
    for (int f = 0; f < W; ++f) delta[f] = hbar[f] * d1[f];
    k7_sweep<W>(sw, dk0, T * R, L, mk, delta, acc);
  }
  k7_write<W>(partials, split, nt, n, w0, ti, val, hess, acc);
}

struct K5Kernel {
  static constexpr bool kOctets = false;
  template <int W, int ACT>
  static constexpr auto get() { return &k5_kernel<W, ACT>; }
};

// New cotangents of layer k's inputs for one point, from the products
// hbar_s = sbar_s W^T and the saved streams (z, p, q, r), written in place.
template <int ACT>
__device__ __forceinline__ void input_cotangents(float hb, float hpb, float hqb, float hrb,
                                                 float& z, float& p, float& q, float& r) {
  float a0, a1, a2, a3;
  act_d<ACT>(z, a0, a1, a2, a3);
  const float zbar = hb * a1 + hpb * (a2 * p) + hrb * (a2 * r) + hqb * (a3 * p * p + a2 * q);
  const float pbar = hpb * a1 + hqb * (2.0f * a2 * p);
  z = zbar;
  p = pbar;
  q = hqb * a1;
  r = hrb * a1;
}

// Weight gradients of layer k into the block's partial row: Wbar[i][j] +=
// sum over the four streams s and the points of h_s(i) sbar_s(j), and the
// bias slot += sum over points of the z stream's cotangent.
__device__ void weight_grads(const Smem& S, const Net& net, int k, float* __restrict__ part) {
  const int win = net.w[k];
  const int wout = net.w[k + 1];
  float* __restrict__ gW = part + net.p_off[k];
  const int n_ig = (win + 3) / 4;
  for (int item = threadIdx.x; item < n_ig * wout; item += kThreads) {
    const int ig = item / wout;
    const int j = item - ig * wout;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 c = ld4(srow(S, net, s, k + 1, j) + g * kGroup);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (4 * ig + r < win) {
            const float4 h = ld4(trow(S, net, s, 4 * ig + r) + g * kGroup);
            acc[r] = fmaf(h.x, c.x, acc[r]);
            acc[r] = fmaf(h.y, c.y, acc[r]);
            acc[r] = fmaf(h.z, c.z, acc[r]);
            acc[r] = fmaf(h.w, c.w, acc[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      if (4 * ig + r < win) gW[static_cast<size_t>(4 * ig + r) * wout + j] += acc[r];
    }
  }
  for (int j = threadIdx.x; j < wout; j += kThreads) {
    const float* zb = srow(S, net, 0, k + 1, j);
    float s = 0.0f;
    for (int p = 0; p < kTile; ++p) s += zb[p];
    gW[win * wout + j] += s;
  }
}

// One step of the backward kernel's reverse sweep through layer k: the
// activated inputs, the weight gradients, then the input cotangents over
// the saved streams of layer k.
template <int ACT>
__device__ void reverse_step(const Smem& S, const Net& net, int k, const float* __restrict__ params_t,
                             float* __restrict__ part) {
  const int win = net.w[k];
  const int wout = net.w[k + 1];
  activate<4, ACT>(S, net, k);
  __syncthreads();
  weight_grads(S, net, k, part);
  const float* __restrict__ Wt = params_t + net.t_off[k];
  for (int item = threadIdx.x; item < kGroups * win; item += kThreads) {
    const int g = item / win;
    const int i = item - g * win;
    float4 acc[4];
#pragma unroll
    for (int s = 0; s < 4; ++s) acc[s] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int j = 0; j < wout; ++j) {
      const float w = __ldg(Wt + static_cast<size_t>(j) * win + i);
#pragma unroll
      for (int s = 0; s < 4; ++s) fma4(acc[s], ld4(srow(S, net, s, k + 1, j) + g * kGroup), w);
    }
    float* zp = srow(S, net, 0, k, i) + g * kGroup;
    float* pp = srow(S, net, 1, k, i) + g * kGroup;
    float* qp = srow(S, net, 2, k, i) + g * kGroup;
    float* rp = srow(S, net, 3, k, i) + g * kGroup;
    float4 z = ld4(zp), p = ld4(pp), q = ld4(qp), r = ld4(rp);
    input_cotangents<ACT>(acc[0].x, acc[1].x, acc[2].x, acc[3].x, z.x, p.x, q.x, r.x);
    input_cotangents<ACT>(acc[0].y, acc[1].y, acc[2].y, acc[3].y, z.y, p.y, q.y, r.y);
    input_cotangents<ACT>(acc[0].z, acc[1].z, acc[2].z, acc[3].z, z.z, p.z, q.z, r.z);
    input_cotangents<ACT>(acc[0].w, acc[1].w, acc[2].w, acc[3].w, z.w, p.w, q.w, r.w);
    st4(zp, z);
    st4(pp, p);
    st4(qp, q);
    st4(rp, r);
  }
  __syncthreads();
}

// K6: the square head's VJP.
template <int ACT>
__global__ void __launch_bounds__(kThreads)
    pw_bwd_kernel(Net net, int nt, int n, int m, int chunk, const float* __restrict__ ax,
                  const float* __restrict__ av, const float* __restrict__ ar,
                  const float* __restrict__ mask, const float* __restrict__ g_val,
                  const float* __restrict__ g_hess, const float* __restrict__ g_dz0,
                  const float* __restrict__ params, const float* __restrict__ params_t,
                  float* __restrict__ w_partials, int n_params,
                  float* __restrict__ x_partials, float* __restrict__ ar_partials) {
  extern __shared__ float4 smem4[];
  const Smem S = carve(reinterpret_cast<float*>(smem4), net, 4);
  const int n_iblk = (n + kTile - 1) / kTile;
  const int iblk = blockIdx.x % n_iblk;
  const int t = (blockIdx.x / n_iblk) % nt;
  const int split = blockIdx.x / (n_iblk * nt);
  const int i0 = iblk * kTile;
  const int j_begin = split * chunk;
  const int j_end = min(m, j_begin + chunk);
  const int w0 = net.w[0];
  const int L = net.n_mid;
  float* gv = S.sc;
  float* gh = S.sc + kRow;
  float* __restrict__ part = w_partials + static_cast<size_t>(blockIdx.x) * n_params;

  load_points(S.cax, ax, t, i0, n, w0);
  load_points(S.cav, av, t, i0, n, w0);
  load_points(S.cr0, g_dz0, t, i0, n, w0);
  load_points(gv, g_val, t, i0, n, 1);
  load_points(gh, g_hess, t, i0, n, 1);
  for (int idx = threadIdx.x; idx < w0 * kRow; idx += kThreads) {
    S.acc1[idx] = 0.0f;
    S.acc2[idx] = 0.0f;
  }
  for (int e = threadIdx.x; e < n_params; e += kThreads) part[e] = 0.0f;
  __syncthreads();

  for (int j = j_begin; j < j_end; ++j) {
    const float mk = __ldg(mask + j);
    float* __restrict__ ar_row = ar_partials + ((static_cast<size_t>(iblk) * nt + t) * m + j) * w0;
    if (mk == 0.0f) {  // block-uniform: this ref adds nothing
      for (int f = threadIdx.x; f < w0; f += kThreads) ar_row[f] = 0.0f;
      continue;
    }
    pair_rows<4>(S, net, ar + (static_cast<size_t>(t) * m + j) * w0);
    __syncthreads();
    forward<4, ACT>(S, net, params);

    // head cotangents of S = mk (gv Phi + gh vHv + <g_dz0, dPhi/dz0>), zero
    // past n
    for (int idx = threadIdx.x; idx < net.w[L] * kTile; idx += kThreads) {
      const int f = idx / kTile;
      const int p = idx - f * kTile;
      const float c = i0 + p < n ? mk : 0.0f;
      float* zr = srow(S, net, 0, L, f) + p;
      float* pr = srow(S, net, 1, L, f) + p;
      float* qr = srow(S, net, 2, L, f) + p;
      float* rr = srow(S, net, 3, L, f) + p;
      const float z = *zr, pp = *pr, q = *qr, r = *rr;
      *zr = c * (2.0f * gv[p] * z + 2.0f * gh[p] * q + 2.0f * r);
      *pr = c * (4.0f * gh[p] * pp);
      *qr = c * (2.0f * gh[p] * z);
      *rr = c * (2.0f * z);
    }
    __syncthreads();
    for (int k = L - 1; k >= 0; --k) reverse_step<ACT>(S, net, k, params_t, part);

    // layer 0 now holds (z0bar, p0bar, q0bar, r0bar)
    for (int idx = threadIdx.x; idx < w0 * kTile; idx += kThreads) {
      const int f = idx / kTile;
      const int p = idx - f * kTile;
      S.acc1[f * kRow + p] += srow(S, net, 0, 0, f)[p];
      S.acc2[f * kRow + p] += srow(S, net, 1, 0, f)[p];
    }
    for (int f = threadIdx.x; f < w0; f += kThreads) {
      const float* zb = srow(S, net, 0, 0, f);
      float s = 0.0f;
      for (int p = 0; p < kTile; ++p) s += zb[p];
      ar_row[f] = -s;
    }
    __syncthreads();
  }

  // this split's ax and av cotangents, each [nt, n, w0]
  const size_t tnw = static_cast<size_t>(nt) * n * w0;
  float* out = x_partials + static_cast<size_t>(split) * 2 * tnw;
  for (int idx = threadIdx.x; idx < kTile * w0; idx += kThreads) {
    const int p = idx / w0;
    const int f = idx - p * w0;
    if (i0 + p < n) {
      const size_t o = (static_cast<size_t>(t) * n + i0 + p) * w0 + f;
      out[o] = S.acc1[f * kRow + p];
      out[tnw + o] = S.acc2[f * kRow + p];
    }
  }
}

// out[e] = sum over rows r of part[r][e] in row order (one chunk, rows <=
// chunk): a thread a column, the columns of a warp one coalesced 128-byte
// line a row.  A kernel of its own: with the chunked kernel's registers a
// block would leave an SM a quarter fewer warps to keep loads in flight.
__global__ void __launch_bounds__(kThreads)
    sum_rows_in_order_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, size_t len) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= len) return;
  float s = 0.0f;
  for (int r = 0; r < rows; ++r) s += part[static_cast<size_t>(r) * len + e];
  out[e] = s;
}

// out[e] = sum over rows r of part[r][e] in the chunk order of
// csrc/row_chunks.cuh (two chunks or more): a warp sums one chunk of rows
// for 32 columns (a lane a column, 16 loads in flight a lane), and the block
// of rank 0 adds the chunk sums in chunk order.
__global__ void __launch_bounds__(kThreads)
    sum_rows_kernel(const float* __restrict__ part, float* __restrict__ out, int rows, size_t len,
                    row_chunks::Plan p) {
  __shared__ float sums[kThreads];  // [warp][lane]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  int chunk, slab;
  row_chunks::position(p, warp, &chunk, &slab);
  const size_t e = (static_cast<size_t>(blockIdx.x) * p.slabs_per_block + slab) * 32 + lane;
  float s = 0.0f;
  if (chunk < p.n_chunks && e < len) {
    const float* __restrict__ col = part + e;
    const int r1 = min(rows, (chunk + 1) * p.chunk);
    int r = chunk * p.chunk;
    for (; r + 16 <= r1; r += 16) {
      float v[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) v[i] = __ldg(col + static_cast<size_t>(r + i) * len);
#pragma unroll
      for (int i = 0; i < 16; ++i) s += v[i];
    }
    for (; r < r1; ++r) s += __ldg(col + static_cast<size_t>(r) * len);
  }
  sums[threadIdx.x] = s;
  row_chunks::sync(p);
  // warp w < slabs_per_block of rank 0 holds chunk 0 of slab w
  if (blockIdx.y == 0 && warp < p.slabs_per_block && e < len) {
    out[e] = row_chunks::add_chunks<32>(p, sums, slab, lane);
  }
  row_chunks::sync(p);  // no block leaves while rank 0 reads its shared memory
}

// sum_rows' launches in this process, counted where they are made (read by
// pw_sum_rows_launches: the wrappers of K5-K8 and S2 count from it)
long long sum_rows_launched = 0;

cudaError_t launch_sum_rows(const float* part, float* out, int rows, size_t len, cudaStream_t st) {
  const row_chunks::Plan p = row_chunks::plan(rows, static_cast<long long>(len), 32);
  if (p.blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t err;
  if (p.n_chunks == 1) {  // the plan's blocks hold kThreads columns each
    sum_rows_in_order_kernel<<<static_cast<unsigned>(p.blocks), kThreads, 0, st>>>(part, out, rows, len);
    err = cudaGetLastError();
  } else {
    err = row_chunks::launch(p, st, sum_rows_kernel, part, out, rows, len, p);
  }
  if (err == cudaSuccess) ++sum_rows_launched;
  return err;
}

// S1: the tile's pair rows against ref blockIdx.x, out of pair_rows<3>:
// z_out, dz_out [m, n, w0] (n <= kTile points, one block a ref).
__global__ void __launch_bounds__(kThreads)
    s1_pair_rows_kernel(Net net, int n, const float* __restrict__ ax, const float* __restrict__ av,
                        const float* __restrict__ ar, float* __restrict__ z_out,
                        float* __restrict__ dz_out) {
  extern __shared__ float4 smem4[];
  const Smem S = carve(reinterpret_cast<float*>(smem4), net, 3);
  const int w0 = net.w[0];
  const int j = blockIdx.x;
  load_points(S.cax, ax, 0, 0, n, w0);
  load_points(S.cav, av, 0, 0, n, w0);
  __syncthreads();
  pair_rows<3>(S, net, ar + static_cast<size_t>(j) * w0);
  __syncthreads();
  for (int idx = threadIdx.x; idx < n * w0; idx += kThreads) {
    const int p = idx / w0;
    const int f = idx - p * w0;
    const size_t o = (static_cast<size_t>(j) * n + p) * w0 + f;
    z_out[o] = srow(S, net, 0, 0, f)[p];
    dz_out[o] = srow(S, net, 1, 0, f)[p];
  }
}

// S1: the collapsed head's M layer on three activated streams g3 [3, n, w]
// (g, gp, gq), out of forward_product<3> with M's zero bias: out [3, n, w].
__global__ void __launch_bounds__(kThreads)
    s1_m_layer_kernel(Net net, int n, const float* __restrict__ g3,
                      const float* __restrict__ params, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  const Smem S = carve(reinterpret_cast<float*>(smem4), net, 3);
  const int w = net.w[0];
  for (int idx = threadIdx.x; idx < 3 * kTile * w; idx += kThreads) {
    const int s = idx / (kTile * w);
    const int rem = idx - s * kTile * w;
    const int p = rem / w;
    const int f = rem - p * w;
    trow(S, net, s, f)[p] = p < n ? g3[(static_cast<size_t>(s) * n + p) * w + f] : 0.0f;
  }
  __syncthreads();
  forward_product<3>(S, net, 0, params);
  __syncthreads();
  for (int idx = threadIdx.x; idx < 3 * n * w; idx += kThreads) {
    const int s = idx / (n * w);
    const int rem = idx - s * n * w;
    const int p = rem / w;
    const int f = rem - p * w;
    out[idx] = srow(S, net, s, 1, f)[p];
  }
}

// Net from the widths; returns the parameter count, or -1 if invalid.
int make_net(int n_mid, const int* widths, Net* net) {
  if (n_mid < 1 || n_mid > kMaxMid) return -1;
  net->n_mid = n_mid;
  int p = 0, t = 0, row = 0, max_in = 0;
  for (int k = 0; k <= n_mid; ++k) {
    if (widths[k] < 1) return -1;
    net->w[k] = widths[k];
    net->row[k] = row;
    row += widths[k];
  }
  for (int k = 0; k < n_mid; ++k) {
    net->p_off[k] = p;
    net->t_off[k] = t;
    p += widths[k] * widths[k + 1] + widths[k + 1];
    t += widths[k] * widths[k + 1];
    if (widths[k] > max_in) max_in = widths[k];
  }
  net->rows = row;
  net->tmp_rows = (max_in + 3) / 4 * 4;
  return p;
}

size_t shared_bytes(const Net& net, int n_streams) {
  return static_cast<size_t>(n_streams * (net.rows + net.tmp_rows) + extra_rows(net.w[0])) * kRow *
         sizeof(float);
}

using launch::allow_shared;
using launch::allow_shared_once;

// the S1 kernels' calls take microseconds: their limits are raised once
size_t s1_pair_rows_allowed[launch::kMaxDevices];
size_t s1_m_layer_allowed[launch::kMaxDevices];

// the tile kernels as with_act takes a kernel: one instantiation an activation
struct PwFwdKernel {
  template <int W, int ACT>
  static constexpr auto get() { return &pw_fwd_kernel<ACT>; }
};

struct PwBwdKernel {
  template <int W, int ACT>
  static constexpr auto get() { return &pw_bwd_kernel<ACT>; }
};

// The kernels a plan names, numbered as ops/cuda/pairwise.py KERNELS lists them
enum KernelId : int { kIdK5 = 0, kIdPwFwd, kIdK6, kIdPwBwd, kIdK7, kIdK8 };

// One launch as the wrapper's plan gives it (ops/cuda/pairwise.py Plan), and
// what follows from it: threads and points (pairs at one ref) a block, the
// dynamic shared memory a block (bytes; the plan's shared_bytes is the same),
// the floats of the weights, and the grid (prologue)
struct Shape {
  int kernel, width, n_layers, n_chunks, w0;  // n_layers hidden layers before the head
  int threads, points;
  size_t smem, weight_floats;
  int point_blocks, blocks;  // ceil(n / points); n_split x nt x point_blocks
  Net net;                   // the tile kernels' chain
};

// `s` from a plan (kernel, width, threads, chain widths[0 .. n_mid], chunks of
// the feature layer); false where its kernel does not take it
bool make_shape(int kernel, int width, int threads, int n_mid, const int* widths, int n_chunks, Shape* s) {
  if (n_mid < 1 || n_mid > kMaxMid || widths == nullptr || widths[0] < 1) return false;
  const int L = n_mid - 1;
  *s = Shape{kernel, width, L, n_chunks, widths[0], threads, threads};
  const bool padded = s->w0 <= width && threads >= 1;
  const bool warps = threads >= 32 && threads % 32 == 0;
  switch (kernel) {
    case kIdPwFwd:
    case kIdPwBwd: {
      const int n_params = make_net(n_mid, widths, &s->net);
      if (n_params < 0) return false;
      s->threads = kThreads;
      s->points = kTile;
      s->smem = shared_bytes(s->net, kernel == kIdPwFwd ? 3 : 4);
      s->weight_floats = n_params;
      return true;
    }
    case kIdK5:
      s->smem = k5_shared_bytes(width, threads, L, n_chunks);
      return padded && threads <= kK5MaxThreads && L <= kMaxMid - 2 && n_chunks >= 1;
    case kIdK6:
      s->points = threads / k8_lanes(width);
      s->smem = k6_shared_bytes(width, threads, L, n_chunks);
      s->weight_floats = k6_weight_floats(width, L, n_chunks);
      return padded && warps && threads <= kK6MaxThreads && L <= kMaxMid - 2 && n_chunks >= 1;
    case kIdK7:
      s->smem = k7_shared_bytes(width, threads, L);
      return padded && threads <= kK7MaxThreads && L <= kMaxMid - 1;
    case kIdK8:
      s->points = threads / 4;
      s->smem = k8_shared_bytes(width, threads, L);
      s->weight_floats = k7_weight_floats(width, L);
      return padded && warps && threads <= kK8MaxThreads && L <= kMaxMid - 1;
    default: return false;
  }
}

// f(the instantiation of the shape's kernel at its width and `act`); an
// unknown width or act returns cudaErrorInvalidValue
template <typename F>
cudaError_t with_shape_kernel(const Shape& s, int act, F&& f) {
  switch (s.kernel) {
    case kIdK5: return with_kernel<K5Kernel>(s.width, act, f);
    case kIdPwFwd: return with_act<PwFwdKernel, 0>(act, f);
    case kIdK6: return with_kernel<K6Kernel>(s.width, act, f);
    case kIdPwBwd: return with_act<PwBwdKernel, 0>(act, f);
    case kIdK7: return with_kernel<K7Kernel>(s.width, act, f);
    default: return with_kernel<K8Kernel>(s.width, act, f);
  }
}

// The prologue of every launch: checks the plan and the sizes (the padded
// kernels' weights 16-byte aligned), sets the grid and selects the device.
cudaError_t prologue(int device, int kernel, int width, int threads, int n_mid, const int* widths,
                     int n_chunks, int nt, int n, int m, int n_split, const float* weights, Shape* s) {
  if (nt <= 0 || n <= 0 || m <= 0 || n_split <= 0 ||
      !make_shape(kernel, width, threads, n_mid, widths, n_chunks, s) ||
      (kernel != kIdPwFwd && kernel != kIdPwBwd && reinterpret_cast<uintptr_t>(weights) % 16 != 0)) {
    return cudaErrorInvalidValue;
  }
  s->point_blocks = (n + s->points - 1) / s->points;
  s->blocks = n_split * nt * s->point_blocks;
  return cudaSetDevice(device);
}

template <typename Kernel, typename... Args>
cudaError_t run(Kernel kern, const Shape& s, cudaStream_t st, Args... args) {
  const cudaError_t err = allow_shared(kern, s.smem);
  if (err != cudaSuccess) return err;
  kern<<<s.blocks, s.threads, s.smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points, bound with ctypes.  Each launches on `stream` and
// returns a CUDA error code (0 on success); validation of shapes, dtypes and
// devices is the Python wrapper's job.  A plan is (kernel, width, threads,
// n_mid, widths, n_chunks): a KernelId, the width instantiation (ignored by
// the tile kernels), threads a block (likewise), the chain as a host array
// widths[0 .. n_mid] (K5, K6 and the tile kernels: w0, the hidden layers'
// output widths, the feature width; K7 and K8: M's width last) and the
// feature layer's chunks (K5: of kK5Chunk features; K6: of `width`).
// Arrays: ax, av [nt, n, w0], ar [nt, m, w0], mask [m], g_val, g_hess [nt,
// n], g_dz0 [nt, n, w0].  weights: the kernel's layout (k5_kernel: [L x (W_k
// [W, W], b_k [W]), W_F [W, F4], b_F [F4]]; k6_kernel: [L x (W_k, b_k),
// n_chunks x (W_F chunk [W, W], b_F chunk [W])]; k7_kernel, k8_kernel: [L x
// (W_k, b_k), M [W, W], u [W]]; zero-padded to `width`, 16-byte aligned;
// the tile kernels: params = [W_k (row-major [w_k, w_{k+1}]), b_k] of every
// layer, with weights_t = params_t packing W_k^T).

// Resident blocks per SM of the plan's kernel at `act`.
extern "C" int pw_max_blocks(int device, int kernel, int act, int width, int threads, int n_mid,
                             const int* widths, int n_chunks, int* blocks) {
  Shape s;
  if (!make_shape(kernel, width, threads, n_mid, widths, n_chunks, &s)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(with_shape_kernel(s, act, [&](auto kern) {
    const cudaError_t e = allow_shared(kern, s.smem);
    if (e != cudaSuccess) return e;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern, s.threads, s.smem);
  }));
}

// The plan's dynamic shared memory a block (bytes; the wrapper's plan
// computes the same), or -1 where its kernel does not take it.
extern "C" long long pw_shared_bytes(int kernel, int width, int threads, int n_mid, const int* widths,
                                     int n_chunks) {
  Shape s;
  if (!make_shape(kernel, width, threads, n_mid, widths, n_chunks, &s)) return -1;
  return static_cast<long long>(s.smem);
}

// The forward sums (k5_kernel, pw_fwd_kernel, k7_kernel) of the plan.
// partials: [n_split, nt * n * (2 + w0)] scratch; out: [nt * n * (2 + w0)] =
// value [nt, n] (K7: without c) | hess [nt, n] | s_dz0 [nt, n, w0].
extern "C" int pw_forward(int device, int kernel, int act, int width, int threads, int n_mid,
                          const int* widths, int n_chunks, int nt, int n, int m, int n_split,
                          const float* ax, const float* av, const float* ar, const float* mask,
                          const float* weights, const float* weights_t, float* partials, float* out,
                          void* stream) {
  Shape s;
  cudaError_t err =
      prologue(device, kernel, width, threads, n_mid, widths, n_chunks, nt, n, m, n_split, weights, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = (m + n_split - 1) / n_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case kIdK5:
      err = with_kernel<K5Kernel>(width, act, [&](auto kern) {
        return run(kern, s, st, s.n_layers, n_chunks, s.w0, nt, n, m, chunk, ax, av, ar, mask, weights,
                   partials);
      });
      break;
    case kIdPwFwd:
      err = with_act<PwFwdKernel, 0>(act, [&](auto kern) {
        return run(kern, s, st, s.net, nt, n, m, chunk, ax, av, ar, mask, weights, weights_t, partials);
      });
      break;
    case kIdK7:
      err = with_kernel<K7Kernel>(width, act, [&](auto kern) {
        return run(kern, s, st, s.n_layers, s.w0, nt, n, m, chunk, ax, av, ar, mask, weights, partials);
      });
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_sum_rows(partials, out, n_split, static_cast<size_t>(nt) * n * (2 + s.w0), st));
}

// The VJP (k6_kernel, pw_bwd_kernel, k8_kernel) of the plan.  Scratch:
// w_partials [blocks, n_w] (a row a block in the layout of `weights`, n_w its
// floats), x_partials [n_split, 2, nt, n, w0], ar_partials [ceil(n / points),
// nt, m, w0].  grads: [n_w] in the layout of `weights` (K8: every W_k, b_k, M
// and u gradient, zero-padded); axv_bar: [2, nt, n, w0] = ax_bar | av_bar;
// ar_bar: [nt, m, w0].
extern "C" int pw_backward(int device, int kernel, int act, int width, int threads, int n_mid,
                           const int* widths, int n_chunks, int nt, int n, int m, int n_split,
                           const float* ax, const float* av, const float* ar, const float* mask,
                           const float* g_val, const float* g_hess, const float* g_dz0, const float* weights,
                           const float* weights_t, float* w_partials, float* grads, float* x_partials,
                           float* axv_bar, float* ar_partials, float* ar_bar, void* stream) {
  Shape s;
  cudaError_t err =
      prologue(device, kernel, width, threads, n_mid, widths, n_chunks, nt, n, m, n_split, weights, &s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int chunk = (m + n_split - 1) / n_split;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (kernel) {
    case kIdK6:
      err = with_kernel<K6Kernel>(width, act, [&](auto kern) {
        return run(kern, s, st, s.n_layers, n_chunks, s.w0, nt, n, m, chunk, ax, av, ar, mask, g_val, g_hess,
                   g_dz0, weights, w_partials, x_partials, ar_partials);
      });
      break;
    case kIdPwBwd:
      err = with_act<PwBwdKernel, 0>(act, [&](auto kern) {
        return run(kern, s, st, s.net, nt, n, m, chunk, ax, av, ar, mask, g_val, g_hess, g_dz0, weights,
                   weights_t, w_partials, static_cast<int>(s.weight_floats), x_partials, ar_partials);
      });
      break;
    case kIdK8:
      err = with_kernel<K8Kernel>(width, act, [&](auto kern) {
        return run(kern, s, st, s.n_layers, s.w0, nt, n, m, chunk, ax, av, ar, mask, g_val, g_hess, g_dz0,
                   weights, w_partials, x_partials, ar_partials);
      });
      break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_sum_rows(w_partials, grads, s.blocks, s.weight_floats, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_sum_rows(x_partials, axv_bar, n_split, static_cast<size_t>(2) * nt * n * s.w0, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_sum_rows(ar_partials, ar_bar, s.point_blocks, static_cast<size_t>(nt) * m * s.w0, st));
}

// S1: pair rows of n <= 32 points against m refs (a block a ref): ax, av
// [n, w0], ar [m, w0] -> z_out, dz_out [m, n, w0].
extern "C" int s1_pair_rows(int device, int w0, int n, int m, const float* ax, const float* av,
                            const float* ar, float* z_out, float* dz_out, void* stream) {
  Net net;
  const int widths[2] = {w0, w0};
  if (n <= 0 || n > kTile || m <= 0 || make_net(1, widths, &net) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = shared_bytes(net, 3);
  err = allow_shared_once(s1_pair_rows_kernel, smem, device, s1_pair_rows_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  s1_pair_rows_kernel<<<m, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(net, n, ax, av, ar, z_out,
                                                                                dz_out);
  return static_cast<int>(cudaGetLastError());
}

// S1: the M layer on the streams of n <= 32 points: g3 [3, n, w], params =
// [M (row-major [w, w]), zeros(w)] -> out [3, n, w] = g3 @ M.
extern "C" int s1_m_layer(int device, int w, int n, const float* g3, const float* params, float* out,
                          void* stream) {
  Net net;
  const int widths[2] = {w, w};
  if (n <= 0 || n > kTile || make_net(1, widths, &net) < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = shared_bytes(net, 3);
  err = allow_shared_once(s1_m_layer_kernel, smem, device, s1_m_layer_allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  s1_m_layer_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(net, n, g3, params, out);
  return static_cast<int>(cudaGetLastError());
}

// The plan of sum_rows (csrc/row_chunks.cuh) for [rows, len] in slabs of
// `slab` columns: out = chunk, n_chunks, warps_per_slab, cluster,
// slabs_per_block, blocks (the Python twin is ops/cuda/row_chunks.py
// sum_rows_plan).
extern "C" void sum_rows_plan_c(long long rows, long long len, int slab, long long* out) {
  const row_chunks::Plan p = row_chunks::plan(rows, len, slab);
  const long long v[6] = {p.chunk, p.n_chunks, p.warps_per_slab, p.cluster, p.slabs_per_block, p.blocks};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
}

// The fixed-order row sum that finishes K5-K8's partial rows, for S1 and
// S2: part [rows, len] -> out [len] in the order of csrc/row_chunks.cuh.
extern "C" int pw_sum_rows(int device, const float* part, float* out, int rows, long long len,
                           void* stream) {
  if (rows <= 0 || len <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_sum_rows(part, out, rows, static_cast<size_t>(len),
                                          static_cast<cudaStream_t>(stream)));
}

// sum_rows' kernel launches so far in this process, from every entry point.
extern "C" long long pw_sum_rows_launches() { return sum_rows_launched; }
