"""Smoke test of the PyTorch / CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``nflows_tpu_torch/csrc`` with nvcc
(sm_90a), holds each against its plain PyTorch version on the card, then
drives the flagship NeuralSplineFlow at full width (features 6, hidden
256, 10 layers x 2 blocks, 8 bins, tail bound 3; random weights from a
fixed seed) through the entry points a user calls. Serving through
``CompiledFlow``: fused (kernel B2, one launch a request) and unfused
(kernel B1 in each of the 10 couplings). Training, 20 Adam steps at batch
512 on both routes: fused (``fused_trainer``: kernel B3, one launch a step;
its composable variant runs B2 forward and B4 backward) and eager
(``make_train_step``: autograd through the unfused chain, ten B1 a
forward). Then the autoregressive family at full width (features 10,
hidden 256, 5 layers x 2 blocks, ReversePermutation, no context): the
whole-chain kernel B9 and its backward B10 against their plain versions on
a MAF (affine), an NSF-AR (rq, 8 bins) and a wrapped IAF chain, B9's fixed
point (MAF and NSF-AR sampling, the IAF's density) on both of its kernels:
the degree kernel (csrc/maf_degree_inverse.cu, the route) against both
plain versions, at both tile sizes, and the fixed-point
kernel (``schedule="fixed_point"``) beside it, each timed; the MAF and
the NSF-AR served through ``CompiledFlow`` fused (B9, one launch a request)
and unfused; the MAF trained for 20 Adam steps on the fused route
(``fused_trainer``: B9 forward and B10 backward a step) and the eager one.
Then the mixture-density family at full width (a MixtureOfGaussiansMADE of
features 10, hidden 256, 2 blocks, 10 components, and its conditional twin,
a MADEMoG with context 10): the log-prob kernel B11 and its backward B12
against their plain versions; both models served through ``CompiledFlow``
fused (B11, one launch a log_prob request; sampling is the model's
sequential sampler) and unfused; both trained for 20 Adam steps on the
fused route (B11 forward and B12 backward a step) and the eager one.
Then the other spline coupling families at the flagship's widths: the
linear-rational NSF (``NeuralSplineFlow(spline="lrs")``) and the same chain
with linear, quadratic or cubic couplings: their elementwise kernels B5-B8
against their plain versions, forward and inverse, with gradients through
each wrapper; each flow served through ``CompiledFlow`` at 4,096 fused (B2,
one launch a request) and unfused (one launch of the family's kernel in
each of the 10 couplings a request) and trained for 20 Adam steps on the
fused (B3), fused-autograd (B2 + B4) and eager (10 launches of the family's
kernel a forward) routes. Then B2's stages for those four families and for
the affine and additive couplings against its plain version, forward and
inverse, on the four flows and on RealNVP at the flagship's widths
(features 6, hidden 256, 10 layers x 2 blocks): ``SimpleRealNVP``, its
volume-preserving (NICE, additive) variant and the same chain with the
GENERAL scale activation; B2 on a narrow quadratic chain with unfolded
weights and ``wh_scale`` (2KT rows past the chain's parameters); B3 and B4
on the four family flows and the three RealNVP variants against their plain
versions; the three RealNVP variants served through ``CompiledFlow`` fused
and unfused; and RealNVP trained for 20 Adam steps on the fused,
fused-autograd and eager routes. Then the conditional coupling flows: the
flagship made conditional (context 10, the MADEMoG twin's width), B2 with its
context path against its plain version forward and inverse at N = 4,096 and
a ragged N, B3 and B4 with the context adjoints (gradients of the context
weights, and B4's cotangent of the context) at 512, 2,048 and 4,096, then the same
three kernels on a conditional affine chain at RealNVP's widths; the
conditional flagship served through ``CompiledFlow`` fused (one B2 a
request) and unfused (ten B1): log_prob of 4,096 samples with 4,096
context rows and 256 samples for each of 16 context rows; and trained 20
Adam steps on the fused, fused-autograd and eager routes with a context.
Then the conditional autoregressive flows at the MAF's widths (context 10):
B9 with its context path against its plain version forward and inverse at
N = 4,096 and a ragged N on a conditional MAF (final MADE weights x 0.1; an
untamed one's inverse held by relative error) and a conditional NSF-AR; B10
with the context adjoint (the four context stacks' gradients and the
context's cotangent) at 512 and 4,096, and B10's inverse direction (the
backward of an IAF's sampling pass) on ``InverseAutoregressiveFlow`` at
those widths and on a conditional IAF; both conditional flows served through
``CompiledFlow`` fused (one B9 a request) and unfused; the conditional MAF
trained as the MAF is; and the
IAF trained by reverse KL against a seeded 10-D correlated Gaussian, 20
steps fused (``FusedIAFTrainer.make_vi_train_step``: one B9 and one B10 a
step) and eager (autograd through the unfused ``transform.inverse``), 400
more fused steps checked by the samples' moments, and the conditional IAF's
step; each route's step timed at 512, 2,048 and 4,096.
Then serving in bf16, the JAX package's default deployment: the bf16-weight
instantiations of B2 (the flagship at 4,096 and 65,536, RealNVP, the
conditional flagship), B9 (the MAF, the NSF-AR, the conditional MAF) and
B11 (the MoG-MADE, the conditional MADEMoG), forward and inverse, each
against its bf16 plain version (every GEMM operand rounded to bf16, fp32
sums) and timed beside its fp32 instantiation; then ``CompiledFlow(dtype=
torch.bfloat16)`` serving the flagship, the MAF and the MoG-MADE at 4,096
on bf16 requests, one launch of the bf16 kernel a log_prob.
B3 and B4, wherever they are held (the flagship, the six other families,
the conditional flagship and affine chain; at 512, 2,048 and 4,096), run at
the cluster size the wrapper chooses and again at every other one their
32-sample tiles can take: one block a tile (csrc/nsf_train.cu) and clusters
of 2, 4 and 8 blocks (csrc/nsf_train_cluster.cu), each held to the plain
version in the same bands; each line says how many tiles, the chosen size,
the grid and the clusters of each size the card holds at once, and the
kernel's time beside one block a tile's. On the flagship every cluster
size is timed at the three sizes, and at 512 also at hidden 64 and 128:
the measurements behind ``nsf_train.cluster_size``'s rule. Phase 7 prints
the cluster size of the fused step's B3. After phase 21, B4 holds the one
tie it has met (``TIE_X``) at every cluster size: the other rows within
the band, each copy of the tie's row within it or shown to be the float64
cotangent of the row moved by 1e-6.
B10 likewise (phases 11 and 27: the MAF, the NSF-AR, the conditional MAF
and NSF-AR, the IAF's inverse direction with and without a context): at
512 and 2,048 at the cluster size its wrapper chooses and at every other
one (one block a tile, csrc/maf_train.cu; clusters of 2, 4 and 8 blocks,
csrc/maf_train_cluster.cu), each held to the plain version in the same
bands, and timed at every size at 512, 2,048 and 4,096 beside the
clusters of each size the card holds at once; the fused MAF, conditional
MAF and IAF steps (phases 12, 29, 30) check that their B10 ran once at the
chosen size and print that size at each timed batch.
B12 likewise (phase 15: the MoG-MADE and its conditional twin): at 512,
2,048, 4,096 and the ragged N at the cluster size its wrapper chooses and
at every other one (one block a tile, csrc/mademog_train.cu; clusters of
2, 4 and 8 blocks, csrc/mademog_train_cluster.cu), each held to the plain
version and float64 in the same bands, and timed at every size at 512,
2,048 and 4,096 beside the clusters of each size the card holds at once;
the fused steps (phase 16) check that their B12 ran once at the chosen
size, and keep that size and the step's wall and busy time by batch.
B2 has two routes (``nsf_flow_kernel.gemm_route``): the tensor-core
kernel (csrc/nsf_flow_wgmma.cu, bf16 wgmma or 3xTF32 for fp32 weights),
which every full-width chain here takes save the fp32 affine couplings,
and the SIMT kernel (csrc/nsf_flow_kernel.cu), which keeps those and the
narrow chains. Phase 4 first
holds one GEMM of the wgmma route alone (``gemm_wgmma``) against
``gemm()``; phases 4 (the flagship at 4,096, 65,536 and a ragged N), 20
(the six other stages), 24 (the context path) and 31 (bf16) hold both
routes, forced by ``gemm=``, against the plain versions in the same
bands, and time both in the same run; the narrow quadratic chain keeps
the SIMT route. Every fused serving request checks that its B2 ran on
the route its shape takes (the route counters ``B2_wgmma``,
``B2_simt`` and their ``_bf16`` twins); the fused-autograd training step
runs the SIMT route, whose layout its trainer re-packs in place.
B9's one-pass direction (the MAF's and NSF-AR's log_prob, the IAF's
sample) has the same two routes (``maf_flow_kernel.gemm_route``): the
tensor-core kernel (csrc/maf_flow_wgmma.cu, _bf16.cu), which every
full-width chain here takes, and the SIMT kernel (csrc/maf_flow_kernel.cu).
Phases 9, 27 and 31 hold both (the route and the SIMT kernel forced) on
the MAF, the NSF-AR and the wrapped IAF chain, with and without a context,
fp32 and bf16, at 512, 4,096, 65,536 and a ragged N as each phase draws
them (fp32 also by its relative errors against float64, within
``ONE_PASS_LIMITS`` of the plain version's, on the MAF and IAF as
initialised too), and time both in the same run with the wgmma route's bound (3xTF32 or bf16 tensor cores)
and the dense count it multiplies beside; phases 10, 28 and 32 check that
a fused log_prob request of the MAF and NSF-AR (an IAF's sample) is one
launch on its route (``B9_wgmma``, ``B9_simt`` and their ``_bf16``
twins) and a sample (an IAF's log_prob) one of the degree kernel; the
fused trainers' B9 runs the SIMT kernel (phases 12 and 29 check
``B9_simt`` and time the wgmma kernel forced on the trainer's weights).
Phase 31 also holds the IAFs' log_prob direction (a fixed point on the
bf16 degree kernel) against its bf16 plain versions, and phase 32 each
bf16 B9 server's log_prob against its bf16 plain version.
B11 has the same two routes (``mademog_fused.gemm_route``): the
tensor-core kernel (csrc/mademog_wgmma.cu, _bf16.cu; the final layer's 300
rows in two passes), which both full-width mixture models take, and the
SIMT kernel (csrc/mademog_fused.cu), which the fused trainer's forward and
the widths the tensor cores do not take keep. Phases 13 (fp32) and 31
(bf16) hold both (the SIMT kernel forced) on the MoG-MADE and the
conditional MADEMoG at 4,096, 65,536 and a ragged N, fp32 also by its
relative errors against float64 within ``ONE_PASS_LIMITS``, and on the
weights phase 16 trains; phase 13 times both at 512, 4,096 and 65,536,
phase 31 at 4,096 and 65,536 beside the fp32 kernel of each route.
Phases 14 and 32 check that a fused log_prob request is one launch on the
wgmma route (``B11_wgmma``, ``B11_wgmma_bf16``) and keep each endpoint's
wall and busy time; phase 16 that the fused step's forward is the SIMT
kernel (``B11_simt``); phase 32 serves a MoG-MADE at hidden 96 in bf16,
one launch of the bf16 SIMT kernel (``B11_simt_bf16``).
Phase 24 holds the conditional flagship's B4 tie (``TIE_CTX``) at every
cluster size.
Phase 33 trains in windows of steps (``make_scan_train_step``): a
window's first two steps at a new batch shape run eagerly, the rest replay
CUDA graphs of eight steps captured once: the fused flagship (B3), MAF
(B9 + B10), MoG-MADE and conditional MADEMoG (B11 + B12) at 512 and 4,096,
and the eager flagship (ten B1 a step) at 512. Each window's wrapper
launches are counted in its first window (the eager steps and the
captures) and must be none in its second (replays only); its losses are
held against the same steps run one by one from identical state on the
card (the eager window bit for bit; MAF, MoG-MADE and MADEMoG within 1e-4
under Adam; the fused flagship under SGD with momentum within 1e-3, since
Adam carries B3's gradient atomics chaotically apart, and under Adam its
first loss bit for bit); the kernels one window replays are counted in the
profiler's trace, which must hold each of them; and each is timed under
Adam as wall, busy and idle a step beside the per-step loop. Then the eager flagship with
dropout 0.1 trains in a window under a CUDA generator: finite and falling
losses, bit for bit the same for the same seed and for the per-step loop
from it, other for another seed, and a second window under a new
generator replaces its graph rather than adding one. The eager route's
step is timed at 512 and 4,096 only (phase 33 reads its host's share at
512), and at 512 only on the four other spline families and RealNVP;
phase 21 times the plain B3 and B4 of those six stages at 512 only (their
holds stay at every batch).
Phase 34 drives the transforms of queue A5. B1 and B5-B8 are held, both
directions, as a learned CDF calls them (4,096 rows of the 3 identity
features, one parameter row a feature shared by the batch), and B7 and
B5 as the quadratic and linear-rational AR transforms call them (at the
AR width), in phase 17's bands. Then it serves, through ``CompiledFlow``
and unfused (no fused kernel has a stage for them; ``use_fused=True``
raises): the flagship's chain with the learned CDF on the identity half
of every coupling, for each of the five spline families (20 launches of
the family's kernel a log_prob request and a sample request: 10
couplings, 10 CDFs); the AR chain at its width with the quadratic and
linear-rational transforms (linear tails: 5 launches of B7 or B5 a
log_prob, 50 a sample) and the linear and cubic ones (bounded splines, no
kernel, fed inputs in [0, 1]); and UMNN at the reference defaults
(integrand 50, 50, 50; cond_size 20; 20 steps): 5 autoregressive layers
at the AR width and 10 couplings at the flagship's, one with the
unconditional normalizer on its identity half, log_prob at 4,096 and
sampling at 512 (no kernel). Each request's launches are counted, its
log_prob held against the same flow on the plain splines (fp32, and in
float64 for the band), its samples' log_prob against log_prob of the
samples, and its wall and busy time printed. Last, 5 eager Adam steps at
512 on the RQ-CDF flow (20 B1 a step), the quadratic AR flow (5 B7) and
the UMNN AR flow: finite losses, and a finite, nonzero gradient for every
CDF row and integrand weight.
Phase 35 drives the transforms of queue A6 (``phase_a6``). An NSF-AR with
an ``LULinear`` after each permutation (``use_linear_layers=True``) at the
AR width, its LU parameters moved off the identity by seeded draws: B1
held, both directions, on the values its first AR transform hands it (after
the permutation and the LU layer), in phase 17's bands; each LULinear's
forward (two products) and inverse (two triangular solves), uncached and
cached, against float64 within 1e-4 of 1 + |f64|; served through
``CompiledFlow`` unfused (every fuser refuses it: ``use_fused=True`` and
``fused_trainer`` raise with the AR prober's reason, ``required=False``
gives None): 5 B1 a log_prob request at 4,096, 50 a sample request at 512,
the log_prob held against the flow on the plain B1 by ``hold_relative``
(floor 1e-6), the samples' log_prob against log_prob of the samples within
5e-3, wall and busy time printed; the same after
``precompute_linear_caches`` (log_prob within 1e-4 of 1 + |uncached|); 5
eager Adam steps at 512 (5 B1 a step); three windows of 8 steps
(``make_scan_train_step``: the warm-up and a capture of 6, a capture of 8,
a replay with no launch) bit for bit against the per-step loop. The
flagship with batch statistics in its conditioners
(``batch_norm_within_layers=True``) at FLAGSHIP: refused by the fused
routes, 10 B1 a log_prob and a sample request at 4,096, held and timed as
above, 5 eager steps. The MAF with ``BatchNorm`` between its layers and
batch statistics in its MADEs (final weights x 0.1) at MAF: refused, a
sample request in training mode raises ``InverseNotAvailable``, then
``initialize_with_data`` on 4,096 rows, eval mode, served (no launch) and 5
eager steps.
Every phase raises on failure, so the exit code is non-zero. Each report
line starts with the seconds since the script began.

Phase 3 also reads the card's floor for one launch, a one-element fill
(``launch_floor_ms`` in the rows of B1 and B5-B8), and times B1 in both
directions at 12,288 and 1,048,575 elements, as phase 17 times B5-B8.

Prints, before the last line, the card's name and power limit, a JSON
line ``{"kernels": [...]}`` with each kernel's launches on the main path
(a serving request for B1, B2, B5-B8, B9_wgmma and B11_wgmma; B1's and
B5-B8's rows also carry phase 34's: ``cdf_launches`` and
``cdf_sample_launches``, a log_prob and a sample request of the flow with
the CDF, and, for B5 and B7, ``ar_launches`` and ``ar_sample_launches``
of the AR flow, with ``cdf_err`` and ``ar_err`` of their holds; B1's row
also phase 35's: ``a6_launches`` and ``a6_sample_launches``, a log_prob and a
sample request of the NSF-AR with LU layers, ``a6_err`` of its hold, and
``a6_flagship_bn_launches``, a request of the batch-normed flagship; a train step for
B3, B4, B10, B11 (its SIMT kernel) and B12, a bf16 request of the MoG-MADE at
hidden 96 for B11_bf16; B9's and B9_bf16's rows count the launches of the
kernels they time, the SIMT kernel's in a train step (``simt_launches``,
none in bf16) and the degree kernel's in a sampling request
(``degree_launches``), and carry the fixed point's times on both kernels
as ``inverse_ms`` and ``inverse_fixed_point_ms``; B10's row also
counts a reverse-KL step as ``inverse_launches``, and carries its cluster
layout: ``cluster_source``, the chosen ``cluster_size`` and
``ms_by_cluster_size`` at each batch, ``active_clusters``, each phase's
launches by cluster size (``cluster_launches_by_phase``) and the fused
steps' cluster size and wall time by batch (``cluster_steps``); B12's row
carries the same keys (and the steps' busy time);
the rows ``B2_bf16``, ``B9_bf16`` and ``B11_bf16``, the bf16-weight
instantiations, count a bf16 request through ``CompiledFlow`` and carry
the fp32 instantiation's time beside theirs as ``fp32_ms``; ``B9`` and
``B9_bf16`` time the SIMT kernel, ``B9_wgmma`` and ``B9_wgmma_bf16`` the
tensor-core one, each with the other's time beside; ``B11`` and
``B11_bf16`` likewise time B11's SIMT kernel, ``B11_wgmma`` and
``B11_wgmma_bf16`` its tensor-core one, with ``simt_ms``, the times at 512
and 65,536, the ragged N's and the trained weights' errors, and the
serving requests' wall and busy times under ``serving``),
error against its plain version, device time (``ms_source`` says whether
torch.profiler or CUDA events gave it), plain time, bound and library time at
the main path's shape (B2's, B3's and B4's rows carry the other six
families' numbers under ``families`` and the conditional flagship's, with
the conditional affine chain's under ``context_families``, as
``context_*``; B2's and B2_bf16's rows carry ``gemm_route``, the route the
request took, ``simt_ms``, the SIMT kernel's time in the same run, and
``bound_basis``, with ``cuda_core_bound_ms`` beside B2's bound);
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Tolerances. Each kernel is held to its plain PyTorch version on the same
inputs: max |kernel - plain| within the stated tolerance, or, where fp32
rounding moves the plain version itself by more than that, max
|kernel - f64| within twice max |plain - f64|, f64 being the plain version
evaluated in float64 on the same inputs. B1 on the values the main path
hands it (the flagship's first coupling): 1e-4 on outputs (a few fp32 ulps
of values up to the tail bound 3) and 1e-3 on the per-element logabsdet (a
log of ratios of small bin quantities, which loses more digits). B1 on
N(0, 1) parameters, a stress case: 1e-2 against float64 on both, because
such parameters make bins ~1e-2 wide with slopes down to 1e-3, where a
one-ulp error of a bin edge moves the inverse by up to ~1e3 ulps; there
the plain fp32 version itself moves by several 1e-4, and the run prints
both. B1, B5, B6, B7 and B8 at every layout of their group of lanes
(``hold_layouts``: ``B1_LAYOUT_BINS``, ``B5_LAYOUT_BINS``,
``B6_LAYOUT_BINS``, ``B7_LAYOUT_BINS`` and ``B8_LAYOUT_BINS``, K = 1 or 2
to 200, which reach
each of the six instantiations of each kernel, on 1,001 and 140,001
elements, 0.5 N(0, 1) parameters from a generator seeded 19): as on the
main path's values, 1e-4 and 1e-3 or twice the plain fp32 version's distance from float64 (at
K = 200 that version lies up to 5.9e-4 from float64 on the logabsdet). B2: 1e-3 on outputs and logabsdet at random init (ten layers of
fp32 GEMMs and splines, summed over 30 elements).
B2's other stages as its rq stage (1e-3, or within twice the plain fp32
version's distance from float64: the affine inverse divides by scales down
to 1e-3, through ten layers); on the narrow quadratic chain 1e-4 (three
layers of width 16).
B3 and B4: log_prob 1e-3 and loss 1e-4 as B2's logabsdet and its mean;
each gradient stack 2e-4 absolute, the bar the JAX package holds its
training kernels to (a weight gradient of the mean loss is a sum over the
batch of fp32 products, taken tile by tile and added with atomics, where
autograd sums in cuBLAS's order); B4's input cotangent 5e-3 after scaling by
N (its cotangents are drawn at scale 1/N, as a mean loss gives them; pulled
back through ten spline layers the scaled values grow well past 1, the run
prints the largest, and the plain fp32 version is itself up to 7e-4 from
float64). Two B3
launches on the same buffers: 1e-5 absolute plus 1e-4 relative, since only
the order of the atomic adds differs. Fused against eager training losses
over the first three steps: 2e-3 (two different fp32 evaluations of an NLL
near 10, then Adam steps whose direction can differ where a gradient is
near zero).
B9 forward: 1e-3 on outputs and logabsdet, as B2. B9 where it runs the fixed
point (the inverse of a MAF or NSF-AR, the forward of an IAF): 5e-3, because
each of the D + 1 MADE passes of a layer feeds its fp32 rounding into the
next through D features and every layer, so two fp32 evaluations in
different summation orders drift apart; the float64 plain version bounds
that drift (the kernel may be no further from it than twice the plain fp32
version is), and the round trip forward(inverse(z)) must return within 5e-3
of z and of -logabsdet: the plain version bounds the arithmetic, float64 the
rounding, the round trip the fixed point itself. Those absolute tolerances
are held on MAF and IAF chains whose final MADE weights are scaled by 0.1.
The degree kernel computes the same function in another order (each unit
once, its masked weights only): it is held in the same bands against both
plain versions, the fixed-point one and the degree one (which share the
float64 reference), and its results at 16- and 32-sample tiles must lie
within 1e-5 of the route's.
The MAF as initialised is held too, by relative error: there the sampling
direction is ill-conditioned (samples of N(0, 1) noise reach 1e18, and the
plain fp32 version is itself up to 2e-2 relative from float64), so the
per-sample relative error against float64, |a - f64| / (1 + |f64|), the
largest over a sample's features, is compared between kernel and plain
version: the kernel's median and 90th percentile over the batch may be at
most twice the plain version's, its 99th percentile at most four times and
its maximum at most ten times. The quantiles are what separates a fault at
extreme scales from rounding: over four seeds the kernel's median and 90th
percentile were 1.1 to 1.5 times the plain version's (a 256-term sum in one
fp32 accumulator against cuBLAS's blocked sums) and its 99th percentile 1.0
to 1.9 times. The maximum is one sample's rounding at the largest condition
number, and the ratio of two such draws spreads: 0.6 to 3.5 over the same
seeds, hence ten. B9's one pass in fp32 is held by the same quantiles
besides its band, each within ten times the plain version's
(``ONE_PASS_LIMITS``): the band (1e-3 on outputs of at most about 1) would
pass a kernel that rounds its products to TF32, while 3xTF32 lies 1.9 to
3.0 times as far from float64 as the plain version. B9 with 32- against
64-sample tiles: 1e-5, a sample's arithmetic does not depend on its tile.
B10: as B4 (gradient stacks
2e-4, gx x N 5e-3), save for the one tie B10 has met (``B10_TIE``): on
that batch and at that cluster size the other samples hold the band, and
that sample holds it or is a tie, the float64 cotangent at the sample
moved by 1e-7, 1e-6 or 1e-5 along one feature lying within the band of
the kernel's and moving by at least half the error there (the far side of
a kink of the chain that close). Masked weights after 20 Adam steps:
bit-equal.
B2, B3 and B4 with a context: the same bands as without (the context adds
C-deep fp32 GEMMs and a sigmoid gate to the same chain); B4's cotangent of
the context x N 5e-3 like gx x N. They are held on the conditional flagship
with its blocks' second linear layers redrawn at the first's scale: as
initialised those start near zero, which leaves the gate's gradients near
1e-5, under the 2e-4 band. Conditional serving: fused against unfused within
1e-3 on log_prob, samples and their log_prob (the same generator gives both
paths the same noise).
B9 and B10 with a context, and B10's inverse direction: the bands above
(the context adds C-deep fp32 GEMMs to the same passes); B10's cotangent of
the context x N 5e-3 like gx x N. There B10's gradient stacks must also lie
within 1e-3 of their largest float64 entry (or twice the fp32 plain
version's distance), and the flows held have their blocks' second linears
redrawn as above: as initialised, the context projections' and first
linears' gradients of a MADE block are near 1e-5, where a kernel writing
zeros would pass 2e-4. The conditional MAF trains with the MAF's checks
(first three losses 2e-3 apart; the last loss under the first and the mean
of the last five under that of the first five), the IAF with the first
three losses 2e-3 apart and the mean of the last five under the first five.
B11: 1e-3 on lp, as B2 (fp32 GEMMs in another order than cuBLAS, then a
logsumexp a feature summed over 10 features), and on either route in fp32
its relative-error quantiles within ``ONE_PASS_LIMITS`` of the plain
version's, as B9's one pass (3xTF32 on the wgmma route). B12: as B10, and gctx x N
5e-3 like gx x N. B5-B8 as B1: on the values the main path hands them
(each flow's first coupling) 1e-4 on outputs and 1e-3 on the logabsdet; on
N(0, 1) parameters 1e-2, or within twice the plain fp32 version's own
distance from float64; their gradients, kernel forward and plain backward,
1e-4 from the plain version's.

bf16 kernels: max |kernel - bf16 plain| within the bands of
benchmarks/hw_numerics.py:68-123 (5e-3 on outputs, 2e-2 on logabsdet and
log_prob), and mean |kernel - bf16 plain| at most a quarter of mean
|kernel - fp32 plain|: the kernel rounds where the plain version, and the
JAX kernel, round. The plain versions' own gap is logged as bf16's price.

Bounds. ``bound_ms`` is the larger of the bytes a function must move over
3.35 TB/s and the fp32 operations it needs over 67 TFLOP/s; for the bf16
rows, the same operation count over the dense bf16 tensor-core rate, 989
TFLOP/s, and the bf16 matrices' bytes. B2 on its wgmma route runs fp32 as
3xTF32, three TF32 products for each product, so its bound counts three
times the operations at the dense TF32 rate, 495 TFLOP/s, with the CUDA-core
bound beside it (``cuda_core_bound_ms``). One GEMM of the wgmma route alone:
within 1e-5 of the largest entry of the product (3xTF32 keeps about fp32's
digits; bf16 products are exact, only the order of the sums differs). For B9 and B10
the operations are counted from the MADE masks of the model in the run: two
for every weight a mask leaves, once a sample for B9 in either direction
(the autoregressive inverse needs each hidden unit and each parameter once,
when the features before it are known), three times for B10. The kernels
multiply the masked zeros too, and B9's fixed-point kernel runs D + 1 full
passes a layer; ``schedule_ms`` is that dense count at the same peak rate
(``inverse_fixed_point_schedule_ms``), and for the degree kernel its slabs
once a sample, pad columns included (``inverse_schedule_ms``). With a
context both counts add the projections, 2 N L (1 + nb) C H a pass (three
times for B10), and the bytes the context and its cotangent. B11 and
B12 count the same way: two FLOP for every MADE weight the masks leave and
every context weight, once a sample for B11 and three times for B12; their
rows carry the conditional twin's numbers as ``context_*``. B11 on its
wgmma route counts as B9's: 3 M over 495 TFLOP/s (3xTF32) or M over 989
(bf16), the dense count it multiplies beside (``dense_ms``). B2 with a context
counts F = 2 N L (Tid H + C H + 4 H^2 + nb C H + H TM) and the context's
bytes, B3 and B4 3 F. B5-B8 count
x, the parameters and two outputs an element (136, 44, 72 and 84 bytes at
K = 8) and an estimate of their fp32 operations an element (B8's inverse
with its 30 bisection halvings); their rows carry the inverse's numbers as
``inverse_*``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

# H100 SXM data sheet, dense, at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12   # dense, on the tensor cores
PEAK_TF32_FLOPS = 495e12   # dense, on the tensor cores
PEAK_BYTES = 3.35e12

# B9's one pass in fp32, on either route: the kernel's per-sample relative
# errors against float64 (hold_relative's median, 90%, 99%, max) within ten
# times the fp32 plain version's. 3xTF32 keeps about 22 of fp32's 24
# significand bits a product, some 4 times fp32's rounding; the wgmma kernel
# measured 1.9-3.0 times the plain version's quantiles on the full-width MAF,
# IAF and conditional MAF as initialised (PERF.md). A single TF32 product
# keeps 11 bits, 2^13 times fp32's rounding, and misses this bound by orders
# of magnitude (tests/test_torch_maf_wgmma_pack.py emulates both).
ONE_PASS_LIMITS = (10.0, 10.0, 10.0, 10.0)

SERVE_BATCH = 4096
RAGGED = SERVE_BATCH - 95   # leaves a last tile of one sample
TRAIN_BATCH = 512
TRAIN_STEPS = 20
FLAGSHIP = dict(features=6, hidden_features=256, num_layers=10,
                num_blocks_per_layer=2, num_bins=8, tail_bound=3.0)
# A tie that B4 has met: sample 1,688 of the cubic chain's inputs at
# N = 2,048 in phase 21, as the shared generator drew them before those
# inputs came from a generator of their own (x, gy, glad; float32 as hex).
# Its path passes 6.7e-7 from a knot of layer 7's spline, closer than fp32
# rounding carries it (1.2e-6), and the float64 cotangent gx x N jumps by
# 0.178 there; B4 at every cluster size, one block a tile included, lands
# on the far side (PERF.md §6, tools/tie_probe.py --held).
TIE_X = ("0x1.f9d346p+0", "0x1.b999e8p-1", "-0x1.a35680p+0", "-0x1.2b4144p+1",
         "0x1.fc6ef8p-6", "-0x1.cb3018p-3")
TIE_GY = ("-0x1.dfbc7cp-13", "0x1.4e35cap-11", "-0x1.76f784p-12", "0x1.25daa6p-12",
          "0x1.3ef326p-13", "0x1.b3ca6ap-11")
TIE_GLAD = "-0x1.edaa94p-12"
TIE_N = 2048
# A tie that B10 has met: sample 1,927 of the NSF-AR's inputs at N = 2,048 in
# phase 11 (drawn from a generator seeded 2,048), at one block a tile. Its
# path passes 7.3e-7 from a knot of the last layer's spline, where fp32
# rounding moves that input by 4.9e-7; csrc/maf_train.cu lands 0.386 off the
# float64 gx x N and 9.6e-6 from the float64 cotangent at the sample moved by
# 1e-5 along one feature, the cluster kernel on the near side (PERF.md §6,
# tools/b10_tie_probe.py).
B10_TIE = dict(model="NSF-AR", n=2048, sample=1927, cluster=1)
TIE_STEPS = (1e-7, 1e-6, 1e-5)
# A tie that B4 has met on the cluster path: sample 122 of the conditional
# flagship's inputs at N = 4,096 in phase 24, as the shared generator drew
# them when phase 4's ragged batch came from it (tools/smoke_replay.py
# --case context4096). Its path passes 6.6e-7 from a knot of layer 4's
# spline, where fp32 rounding moves it by 2.7e-7; B4 on clusters of 2, 4 and
# 8 lands 0.483 off the float64 gx x N in every launch (one block a tile
# 1.2e-3 at most over the batch), and the float64 cotangent at the sample
# moved by 3e-6 along feature 5 jumps by 0.483 (gctx x N by 0.024): the
# cluster kernel's rounding takes it across the knot (PERF.md §6, ROADMAP.md
# C5). Held in phase 24 at every cluster size by hold_tie.
TIE_CTX = dict(
    n=4096, sample=122,
    x=("0x1.697df0p-10", "-0x1.f2a5ecp+0", "0x1.0c22b0p+0", "-0x1.e30960p-3",
       "0x1.371e6ap-1", "0x1.640d6ap-1"),
    gy=("-0x1.7475c8p-18", "0x1.424c36p-12", "-0x1.1fd968p-12", "-0x1.07650cp-13",
        "-0x1.c387a8p-13", "0x1.15bf08p-13"),
    glad="0x1.4c05f4p-15",
    ctx=("-0x1.c0df66p-3", "-0x1.9a6324p-1", "0x1.2e45e8p+0", "0x1.aca8aap-2",
         "0x1.4bd32ap+0", "0x1.913d90p-3", "0x1.48bed6p-1", "0x1.001d5ap+1",
         "0x1.012bf8p+0", "0x1.91fa5cp+0"))
# the autoregressive family at full width: MAF (affine) and NSF-AR (rq)
# the K at which phases 3 and 17 hold B1, B5, B6, B7 and B8 on their group of lanes
# (csrc/spline_lanes.cuh: G = lanes_for(ceil(K / 4)) lanes of 4 bins, past 128
# bins the whole warp in chunks): each of the six instantiations of each
# kernel, G = 2, 4, 8, 16, 32 and 32 chunked, at a K whose rows take 16-byte
# loads (K % 4 == 0) and, where the layout allows, at one that does not
B1_LAYOUT_BINS = (1, 5, 8, 13, 16, 27, 32, 40, 100, 127, 200)
B7_LAYOUT_BINS = (2, 5, 8, 13, 16, 27, 32, 40, 100, 127, 200)
# ... and B5, B6 and B8 on the same layout (B8's K = 129: bin 128, whose size
# the knot derivative of bin 127 needs, lies in the next chunk)
B5_LAYOUT_BINS = (1, 5, 8, 13, 16, 27, 32, 40, 100, 127, 200)
B6_LAYOUT_BINS = (1, 5, 8, 13, 16, 27, 32, 40, 100, 127, 200)
B8_LAYOUT_BINS = (1, 5, 8, 13, 16, 27, 32, 40, 100, 127, 129, 200)
MAF = dict(features=10, hidden_features=256, num_layers=5, num_blocks_per_layer=2)
NSF_AR = dict(**MAF, num_bins=8, tail_bound=3.0)
# the mixture-density family: "a typical neural-density-estimation config"
# (benchmarks/bench_fused_mademog.py), and its conditional twin
MOG = dict(features=10, hidden_features=256, num_blocks=2, num_mixture_components=10)
MOG_CONTEXT = 10
# RealNVP at the flagship's widths (bench.py's features, hidden and depth)
REALNVP = dict(features=6, hidden_features=256, num_layers=10, num_blocks_per_layer=2)


_START = time.perf_counter()


def log(*args):
    """A line of the run's report, after the seconds since the script began."""
    print(f"[{time.perf_counter() - _START:6.1f} s]", *args, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def call_ms(torch, fn, iters):
    """Mean time of one call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events, after one warm-up call: device time plus any gap
    the host leaves between launches."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def queued_ms(torch, fn, iters):
    """:func:`call_ms` with the calls queued behind a spin of the card
    (``torch.cuda._sleep``) long enough for the host to issue them all, so
    that the events time the card's work and not the host's time to issue
    each call, which exceeds a short kernel's (B11's bf16 kernel read 0.0706
    ms by plain events against 0.0244 ms of device busy time a request, on
    an NVIDIA H100 80GB HBM3 at 700 W). A call that waits on the card itself
    gains nothing from the queue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    issue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # about 2e9 cycles a second on the H100; twice the host's issue time
    torch.cuda._sleep(min(int(4e9 * issue_s * iters), int(2e9)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, iters, kernel=None):
    """Mean device time of one call of ``fn``: the summed duration of the
    kernels it runs (those whose name contains ``kernel``, of which ``fn``
    launches one a call; or all), from torch.profiler's CUDA trace. Falls
    back to :func:`queued_ms` if the trace holds no device time or not every
    launch of the named kernel. ``device_ms.source`` says which of the two
    the last reading came from: ``"profiler"`` or ``"events"``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    pad = torch.empty(1, device="cuda")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        # the trace can lose the records nearest its ends: pad both with a
        # one-element fill, so that what is lost is the padding
        pad.zero_()
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        pad.zero_()
        torch.cuda.synchronize()
    total_us, seen = 0.0, 0
    for evt in prof.key_averages():
        if kernel is None or kernel in evt.key:
            total_us += getattr(evt, "self_device_time_total", 0.0) or 0.0
            seen += evt.count
    if total_us <= 0.0 or (kernel is not None and seen != iters):
        log(f"  (the profiler's trace is incomplete: {seen} records of {kernel or 'any kernel'} "
            f"for {iters} calls; timing with CUDA events, the calls queued)")
        device_ms.source = "events"
        return queued_ms(torch, fn, iters)
    device_ms.source = "profiler"
    return total_us / 1e3 / iters


def host_ops(fn, iters=10, top=8):
    """Where the host's time goes in ``fn``: the operations with the most
    self CPU time over ``iters`` calls, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(iters):
            fn()
    events = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)
    total = sum(e.self_cpu_time_total for e in events) / 1e3 / iters
    log(f"  host time of a call, by operation ({total:.3f} ms of self CPU time a call in "
        "all, under the profiler):")
    for e in events[:top]:
        log(f"    {e.key}: {e.self_cpu_time_total / 1e3 / iters:.3f} ms, "
            f"{e.count // iters} a call")


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def hold(name, kernel, plain32, plain64, tol, rel=None):
    """Hold a kernel result to its plain version (see the module doc). With
    ``rel``, the kernel must also lie within ``rel`` times the largest
    |float64| entry of float64 (or within twice the fp32 plain version's
    distance): a band wider than the values it holds passes zeros.
    Returns max |kernel - plain|."""
    err_kp = max_err(kernel, plain32)
    err_k64 = max_err(kernel, plain64)
    err_p64 = max_err(plain32, plain64)
    ok = err_kp <= tol or err_k64 <= 2.0 * err_p64
    largest = float(plain64.abs().max())
    if rel is not None:
        ok = ok and (err_k64 <= rel * largest or err_k64 <= 2.0 * err_p64)
    log(f"  {name}: |kernel-plain| {err_kp:.3e}  |kernel-f64| {err_k64:.3e}  "
        f"|plain-f64| {err_p64:.3e}  tol {tol:.0e}"
        + ("" if rel is None else f", {rel:.0e} of the largest |f64| {largest:.3e}")
        + f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return err_kp


def moved_cotangents(backward, x, gy, glad, step, context=None):
    """``backward``'s (gx, gradients) in float64 at one sample (x, gy, glad
    and the context, rows [1, .]) moved by -step, +step along each feature
    in turn: row e has feature e // 2 moved, by +step where e is odd.
    ``backward(x, gy, glad, context=)`` is a plain backward (B4's, B10's)
    on fixed weights."""
    m = 2 * x.shape[1]
    rows = x.double().repeat(m, 1)
    for e in range(m):
        rows[e, e // 2] += step if e % 2 else -step
    return backward(rows, gy.double().repeat(m, 1), glad.double().repeat(m),
                    context=None if context is None else context.double().repeat(m, 1))


def hold_tie(torch, what, got, plain, exact, moved, n, s, ind=""):
    """``hold`` of a cotangent x N (``what``: gx, gctx) on a batch of n
    samples that holds a tie at sample s: the other samples as ``hold``;
    that sample within the band of float64, or a tie: the float64
    cotangent at the sample moved by one of ``TIE_STEPS`` along one feature
    (``moved(step)``, rows [2 D, .] as ``moved_cotangents`` gives them)
    lies within the band of the kernel's and moves by at least half the
    error there. Returns (max |kernel - plain| over the other samples, what
    the tie showed)."""
    tol = 5e-3
    rest = torch.arange(n, device=got.device) != s
    err_kp = hold(f"{ind}{what}, all samples but {s}", got[rest] * n, plain[rest] * n,
                  exact[rest] * n, tol)
    err = float((got[s].double() - exact[s]).abs().max()) * n
    seen = []
    for step in TIE_STEPS:
        m = moved(step)
        near = (m - got[s].double()).abs().amax(1) * n
        e = int(near.argmin())
        seen.append((float(near[e]), step, e, float((m[e] - exact[s]).abs().max()) * n))
    near, step, e, move = min(seen)
    ok = err <= tol or (near <= tol and move >= 0.5 * err)
    log(f"  {ind}{what}, sample {s}: |kernel-f64| {err:.3e}; nearest float64 cotangent at the "
        f"sample moved by {'+' if e % 2 else '-'}{step:.0e} along feature {e // 2}: "
        f"{near:.3e}, which moves by {move:.3e} there; tol {tol:.0e}  "
        f"{('ok' if err <= tol else 'a tie') if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{what} on a held tie: sample {s} is past the band and is not "
                             "a tie")
    return err_kp, dict(sample=s, err=err, nearest_moved=near, step=step, move=move,
                        tie=err > tol)


def hold_b10_tie(torch, got, plain, exact, backward, x, gy, glad, ind=""):
    """``hold_tie`` of B10's gx x N on ``B10_TIE``'s batch and cluster size
    (``backward``: the float64 plain backward)."""
    n, s = B10_TIE["n"], B10_TIE["sample"]
    return hold_tie(torch, "gx * N", got, plain, exact,
                    lambda step: moved_cotangents(backward, x[s:s + 1], gy[s:s + 1],
                                                  glad[s:s + 1], step)[0], n, s, ind)


def hold_exact(name, kernel, plain32, plain64, tol):
    """Hold a kernel result to the float64 plain version within ``tol``."""
    err = max_err(kernel, plain64)
    log(f"  {name}: |kernel-f64| {err:.3e}  |plain-f64| {max_err(plain32, plain64):.3e}  "
        f"|kernel-plain| {max_err(kernel, plain32):.3e}  tol {tol:.0e}")
    if not err <= tol:
        raise AssertionError(f"{name}: kernel is {err:.3e} from float64")
    return err


def hold_relative(torch, name, kernel, plain32, plain64, limits=(2.0, 2.0, 4.0, 10.0),
                  floor=0.0):
    """Hold a kernel to its plain version where values span many orders of
    magnitude and both fp32 evaluations are far from float64 (see the module
    doc), or where a kernel rounds on other units than the plain version
    (``ONE_PASS_LIMITS``): per-sample relative errors against float64, the
    kernel's quantiles (median, 90%, 99%, max) within ``limits`` times the
    plain version's, or at most ``floor``."""
    def quantiles(t):
        e = (t.double() - plain64).abs() / (1.0 + plain64.abs())
        e = e.reshape(e.shape[0], -1).max(dim=1).values
        q = torch.quantile(e, torch.tensor([0.5, 0.9, 0.99], dtype=e.dtype, device=e.device))
        return [*q.tolist(), float(e.max())]

    k, p = quantiles(kernel), quantiles(plain32)
    ok = all(a <= f * b or a <= floor for a, b, f in zip(k, p, limits))
    fmt = lambda v: " ".join(f"{x:.2e}" for x in v)  # noqa: E731
    log(f"  {name}, relative error against f64 (median, 90%, 99%, max): kernel {fmt(k)}  "
        f"plain {fmt(p)}  limits " + " ".join(f"x{f:g}" for f in limits)
        + (f" or {floor:.0e}" if floor else "") + f"  {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: the kernel's error is not the plain version's rounding")
    return k, p


def hold_layouts(torch, kid, wrapper, plain, widths, bins, device):
    """Hold an elementwise spline kernel of the group-of-lanes layout (B1,
    B5, B6, B7, B8) at each K of ``bins`` (``widths(K)``: its parameters' widths) on
    1,001 and 140,001 elements (one round a warp, and full warps of
    rounds), both directions, 0.5 N(0, 1) parameters and inputs
    at and past the tail bound 3, as ``hold`` holds the main path's values
    (1e-4 on outputs, 1e-3 on the logabsdet, or twice the plain version's
    distance from float64). The draws come from a generator of their own,
    seeded 19, so that the shared generator's draws for later phases stay
    as they were. Returns the largest |kernel - plain|."""
    rng = np.random.default_rng(19)
    worst = 0.0
    for K in bins:
        for n in (1001, 140001):
            x = (2.5 * rng.standard_normal(n)).astype(np.float32)
            x[:4] = [3.0, -3.0, 3.5, -3.5]
            args = [torch.from_numpy(a).to(device) for a in
                    [x] + [(0.5 * rng.standard_normal((n, p))).astype(np.float32)
                           for p in widths(K)]]
            for inverse in (False, True):
                kw = dict(inverse=inverse, tail_bound=3.0)
                out, lad = wrapper(*args, **kw)
                p_out, p_lad = plain(*args, **kw)
                d_out, d_lad = plain(*[t.double() for t in args], **kw)
                torch.cuda.synchronize()
                tag = f"{kid} K={K} at {n} elements, {'inverse' if inverse else 'forward'}"
                worst = max(worst, hold(f"{tag} out", out, p_out, d_out, 1e-4),
                            hold(f"{tag} lad", lad, p_lad, d_lad, 1e-3))
    return worst


def family_inputs(family, flow, x):
    """What the first coupling of ``flow`` hands its spline kernel for inputs
    ``x``: the transformed features, then the spline parameters in the
    wrapper's order (widths and heights rescaled as the coupling does), as
    contiguous tensors. ``family`` is rq, lrs, linear, quadratic or cubic."""
    perm, cpl = flow.transform.transforms[0], flow.transform.transforms[1]
    z, _ = perm(x)
    params = cpl.transform_net(z[:, cpl.identity_features])
    params = params.reshape(x.shape[0], cpl.num_transform_features, -1)
    K = cpl.num_bins
    if family == "linear":
        parts = [params]
    else:
        w, h = cpl._softmax_rescale(
            params[..., :K], params[..., K:] if family == "quadratic" else params[..., K:2 * K])
        parts = {"rq": [w, h, params[..., 2 * K:]],
                 "lrs": [w, h, params[..., 3 * K:], params[..., 2 * K:3 * K]],
                 "quadratic": [w, h],
                 "cubic": [w, h, params[..., 2 * K:2 * K + 1], params[..., 2 * K + 1:]]}[family]
    return [t.contiguous() for t in (z[:, cpl.transform_features], *parts)]


def family_flow(family, device, seed, cdf=False, **overrides):
    """The flagship's chain at its widths (FLAGSHIP, or ``overrides`` of it)
    with a coupling of ``family`` (rq, lrs, linear, quadratic or cubic): 10 x
    [RandomPermutation, coupling with a 2-block relu ResidualNet], alternating
    masks, 8 bins, linear tails at 3, StandardNormal base, random weights from
    ``seed`` (the repo builds these chains in benchmarks/hw_numerics.py:79-100
    and tests/ops/test_spline_couplings_fused.py:27-29). With ``cdf``, each
    coupling also carries its family's learned CDF on the identity half
    (``apply_unconditional_transform=True``), drawn from the same seed."""
    import torch

    from nflows_tpu_torch import Flow
    from nflows_tpu_torch.distributions import StandardNormal
    from nflows_tpu_torch.nn import nets
    from nflows_tpu_torch.transforms import (
        CompositeTransform,
        PiecewiseCubicCouplingTransform,
        PiecewiseLinearCouplingTransform,
        PiecewiseLinearRationalCouplingTransform,
        PiecewiseQuadraticCouplingTransform,
        PiecewiseRationalQuadraticCouplingTransform,
        RandomPermutation,
    )
    from nflows_tpu_torch.utils.masks import create_alternating_binary_mask

    cls = {"rq": PiecewiseRationalQuadraticCouplingTransform,
           "lrs": PiecewiseLinearRationalCouplingTransform,
           "linear": PiecewiseLinearCouplingTransform,
           "quadratic": PiecewiseQuadraticCouplingTransform,
           "cubic": PiecewiseCubicCouplingTransform}[family]
    cfg = {**FLAGSHIP, **overrides}
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    chain = []
    for i in range(cfg["num_layers"]):
        chain.append(RandomPermutation(cfg["features"], rng=rng, device=device))
        chain.append(cls(
            mask=create_alternating_binary_mask(cfg["features"], even=bool(i % 2)),
            transform_net_create_fn=lambda n_in, n_out: nets.ResidualNet(
                n_in, n_out, hidden_features=cfg["hidden_features"],
                num_blocks=cfg["num_blocks_per_layer"], generator=gen, device=device),
            num_bins=cfg["num_bins"], tails="linear", tail_bound=cfg["tail_bound"],
            apply_unconditional_transform=cdf, generator=gen, device=device))
    return Flow(CompositeTransform(chain), StandardNormal([cfg["features"]])).to(device).eval()


def realnvp_flow(kind, device, seed, context_features=None):
    """RealNVP at the flagship's widths (REALNVP): ``SimpleRealNVP`` with
    affine couplings ("affine") or volume-preserving additive ones
    ("additive"), or the same chain of ``AffineCouplingTransform`` with the
    GENERAL scale activation ("general", as tests/ops/test_realnvp_fused.py:77-98
    builds it: flipping checkerboard masks, no permutations); with
    ``context_features``, that chain with the DEFAULT activation and a
    context in every conditioner (SimpleRealNVP takes none); random weights
    from ``seed``, each conditioner's final-layer weights scaled by 0.1. At
    the library's initialisation a full-width RealNVP's inverse is
    ill-conditioned, as the MAF's is (``tame``): a large feature drives the
    next layers' scales toward 1e-3, and samples of N(0, 1) noise reach 2e9
    (DEFAULT) or 1e17 (GENERAL) on the unfused chain as through B2, where
    no error bar means anything. A trained flow maps noise to data; the
    smaller final weights give the random model that conditioning."""
    import torch

    from nflows_tpu_torch import Flow, SimpleRealNVP
    from nflows_tpu_torch.distributions import StandardNormal
    from nflows_tpu_torch.nn import nets
    from nflows_tpu_torch.transforms import AffineCouplingTransform, CompositeTransform

    gen = torch.Generator().manual_seed(seed)
    if kind != "general" and context_features is None:
        return tame_couplings(SimpleRealNVP(**REALNVP, use_volume_preserving=kind == "additive",
                                            generator=gen, device=device))
    mask = np.ones(REALNVP["features"], dtype=np.float32)
    mask[::2] = -1
    layers = []
    for _ in range(REALNVP["num_layers"]):
        layers.append(AffineCouplingTransform(
            mask=mask, transform_net_create_fn=lambda n_in, n_out: nets.ResidualNet(
                n_in, n_out, hidden_features=REALNVP["hidden_features"],
                num_blocks=REALNVP["num_blocks_per_layer"], context_features=context_features,
                generator=gen, device=device),
            scale_activation=(AffineCouplingTransform.GENERAL_SCALE_ACTIVATION
                              if kind == "general"
                              else AffineCouplingTransform.DEFAULT_SCALE_ACTIVATION),
            device=device))
        mask = mask * -1
    return tame_couplings(Flow(CompositeTransform(layers),
                               StandardNormal([REALNVP["features"]])).to(device))


def tame_couplings(flow, factor=0.1):
    """Scale every coupling conditioner's final-layer weights by ``factor``."""
    import torch

    with torch.no_grad():
        for t in flow.transform.transforms:
            t.transform_net.final_layer.weight.mul_(factor)
    return flow.eval()


def phase_a6(torch, dev, counts, serve_times):
    """Phase 35: the transforms of queue A6 (see the module doc). ``counts``
    holds the launch counters' ``reset``, ``read`` and ``expect``;
    ``serve_times`` takes each request's wall and busy time. Returns the keys
    B1's row gains and what the phase measured."""
    import copy
    from contextlib import contextmanager

    from nflows_tpu_torch import (
        CompiledFlow,
        MaskedAutoregressiveFlow,
        NeuralSplineFlow,
        NeuralSplineFlowAR,
        create_train_state,
        fused_trainer,
        make_scan_train_step,
        make_train_step,
    )
    from nflows_tpu_torch.core import _window
    from nflows_tpu_torch.ops.cuda import rq_spline
    from nflows_tpu_torch.ops.splines import rational_quadratic as rq
    from nflows_tpu_torch.transforms import LULinear, precompute_linear_caches
    from nflows_tpu_torch.transforms.base import InverseNotAvailable

    t_a6 = time.perf_counter()
    B, K, D, L = NSF_AR["tail_bound"], NSF_AR["num_bins"], NSF_AR["features"], NSF_AR["num_layers"]
    FD, FL = FLAGSHIP["features"], FLAGSHIP["num_layers"]
    g = torch.Generator().manual_seed(35)
    b1_keys, stats = {}, {}

    @contextmanager
    def plain_b1():
        """B1's wrapper replaced by its plain version (same arguments)."""
        saved = rq_spline.rq_spline_cuda
        rq_spline.rq_spline_cuda = rq.unconstrained_rational_quadratic_spline_plain
        try:
            yield
        finally:
            rq_spline.rq_spline_cuda = saved

    def relative(a, b):
        """max |a - b| / (1 + |b|)."""
        return float(((a.double() - b.double()).abs() / (1.0 + b.double().abs())).max())

    def refused(model, flow, features, reason):
        """``use_fused=True`` and ``fused_trainer`` raise with ``reason``;
        ``fused_trainer(required=False)`` returns None."""
        for what, build in (
                ("CompiledFlow(use_fused=True)", lambda: CompiledFlow(
                    flow, batch_size=SERVE_BATCH, features=features, use_fused=True)),
                ("fused_trainer", lambda: fused_trainer(flow, TRAIN_BATCH))):
            try:
                build()
            except ValueError as e:
                if reason not in str(e):
                    raise AssertionError(f"{model}: {what} refused for another reason: {e}")
            else:
                raise AssertionError(f"{model}: {what} did not raise")
        if fused_trainer(flow, TRAIN_BATCH, required=False) is not None:
            raise AssertionError(f"{model}: fused_trainer(required=False) gave a trainer")
        log(f"{model}: the fused routes refuse it ({reason!r})")

    def serve_a6(model, flow, features, lp_counts, sample_counts, num_samples, kernel=True,
                 calls=10, x=None):
        """Serve ``flow`` through CompiledFlow(use_fused=None), which must
        take the unfused chain: the launches of a log_prob request of
        SERVE_BATCH inputs ``x`` (default: drawn here) (``lp_counts``) and
        of a sample_and_log_prob request of
        ``num_samples`` (``sample_counts``); with ``kernel``, the log_prob
        held against the same flow on the plain B1 by ``hold_relative``
        (floor 1e-6, as phase 34); the samples' log_prob against log_prob of
        the samples within 5e-3; both requests timed (wall over ``calls``,
        busy over a third of them)."""
        server = CompiledFlow(flow, batch_size=SERVE_BATCH, features=features,
                              num_samples=num_samples)
        if server.is_fused:
            raise AssertionError(f"{model}: CompiledFlow fused a chain no kernel takes")
        if x is None:
            x = torch.randn(SERVE_BATCH, features, generator=g).to(dev)
        counts.reset()
        lp = server.log_prob(x)
        torch.cuda.synchronize()
        first = counts.read()
        counts.reset()
        s, s_lp = server.sample_and_log_prob(torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        second = counts.read()
        log(f"serving {model} (unfused): launches a log_prob request "
            f"{ {k: v for k, v in first.items() if v} }, a sample request of {num_samples} "
            f"{ {k: v for k, v in second.items() if v} }")
        counts.expect(f"one {model} log_prob request", first, **lp_counts)
        counts.expect(f"one {model} sample request", second, **sample_counts)
        for t_, shape in ((lp, (SERVE_BATCH,)), (s, (num_samples, features)),
                          (s_lp, (num_samples,))):
            if tuple(t_.shape) != shape or not torch.isfinite(t_).all():
                raise AssertionError(f"{model}: bad output {tuple(t_.shape)}")
        flow64 = copy.deepcopy(flow).double()
        with torch.no_grad(), plain_b1():
            p_lp = flow.log_prob(x)
            d_lp = flow64.log_prob(x.double())
        if kernel:
            hold_relative(torch, f"{model} log_prob against the flow on the plain B1", lp, p_lp,
                          d_lp, floor=1e-6)
        log(f"  |served-plain| {max_err(lp, p_lp):.3e}  |served-f64| {max_err(lp, d_lp):.3e}  "
            f"|plain-f64| {max_err(p_lp, d_lp):.3e}")
        with torch.no_grad():
            gap = max_err(s_lp, flow.log_prob(s))
        log(f"  sample_and_log_prob vs log_prob(samples): {gap:.3e} (limit 5e-3)  "
            f"{'ok' if gap <= 5e-3 else 'FAIL'}")
        if not gap <= 5e-3:
            raise AssertionError(f"{model}: sample_and_log_prob disagrees with log_prob")
        out = dict(err=max_err(lp, p_lp), consistency=gap,
                   log_prob_launches={k: v for k, v in first.items() if v},
                   sample_launches={k: v for k, v in second.items() if v})
        for endpoint, fn in (("log_prob", lambda: server.log_prob(x)),
                             ("sample", lambda: server.sample(
                                 torch.Generator(device=dev).manual_seed(3)))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / calls
            busy = device_ms(torch, fn, max(1, calls // 3))
            log(f"  {endpoint}: {wall:.3f} ms a request of "
                f"{SERVE_BATCH if endpoint == 'log_prob' else num_samples} (host clock), "
                f"device busy {busy:.3f} ms")
            serve_times[f"{model}, unfused, {endpoint}"] = dict(wall_ms=wall, busy_ms=busy)
            out[f"{endpoint}_wall_ms"], out[f"{endpoint}_busy_ms"] = wall, busy
        stats[model] = out
        return x, lp, first, second

    def train_a6(model, flow, features, expected):
        """5 eager Adam steps at TRAIN_BATCH on a copy of ``flow`` in training
        mode: a step's launches ``expected`` and finite losses."""
        state = create_train_state(copy.deepcopy(flow).train(),
                                   lambda prm: torch.optim.Adam(prm, lr=1e-3))
        step = make_train_step()
        data = [1.5 * torch.randn(TRAIN_BATCH, features, generator=g).to(dev) + 0.5
                for _ in range(5)]
        losses = []
        t0 = time.perf_counter()
        for i, batch in enumerate(data):
            counts.reset()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if i == 0:
                first = counts.read()
        wall = 1e3 * (time.perf_counter() - t0) / len(data)
        counts.expect(f"an eager {model} step", first, **expected)
        log(f"training {model} eagerly: launches a step {({k: v for k, v in first.items() if v})}"
            f"; losses " + " ".join(f"{v:.4f}" for v in losses) + f"; {wall:.1f} ms a step "
            "(host clock, the first included)")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{model}: non-finite losses {losses}")
        stats[f"{model}, training"] = dict(losses=losses, step_ms=wall)

    # (a) NSF-AR with an LULinear after each permutation, at NSF_AR's widths;
    # the LU layers start as the identity: move them by seeded draws
    lu_flow = NeuralSplineFlowAR(**NSF_AR, use_linear_layers=True,
                                 generator=torch.Generator().manual_seed(35),
                                 rng=np.random.default_rng(35), device=dev).eval()
    lus = [m for m in lu_flow.modules() if isinstance(m, LULinear)]
    with torch.no_grad():
        for m in lus:
            for p in (m.lower_entries, m.upper_entries):
                p.copy_(0.3 / D ** 0.5 * torch.randn(p.shape, generator=g))
            m.unconstrained_upper_diag.add_(0.3 * torch.randn(D, generator=g).to(dev))
            m.bias.copy_(0.1 * torch.randn(D, generator=g))
    perm, lu, ar = lu_flow.transform.transforms[:3]
    with torch.no_grad():
        x = torch.randn(SERVE_BATCH, D, generator=g).to(dev)
        z, _ = lu(perm(x)[0])
        z.view(-1)[:4] = torch.tensor([B, -B, B + 0.5, -B - 0.5])
        p = ar.autoregressive_net(z).reshape(SERVE_BATCH, D, -1)
        s = ar._hidden_scale()
        args = [t.contiguous() for t in (z, p[..., :K] * s, p[..., K:2 * K] * s, p[..., 2 * K:])]
        log(f"B1 as the NSF-AR with LU layers calls it, at {z.numel()} elements:")
        errs = []
        for inverse in (False, True):
            kw = dict(inverse=inverse, tail_bound=B)
            out, lad = rq_spline.rq_spline_cuda(*args, **kw)
            p_out, p_lad = rq.unconstrained_rational_quadratic_spline_plain(*args, **kw)
            d_out, d_lad = rq.unconstrained_rational_quadratic_spline_plain(
                *[t.double() for t in args], **kw)
            torch.cuda.synchronize()
            tag = "inverse" if inverse else "forward"
            errs += [hold(f"B1 {tag} out", out, p_out, d_out, 1e-4),
                     hold(f"B1 {tag} lad", lad, p_lad, d_lad, 1e-3)]
        b1_keys["a6_err"] = max(errs)
        # each LULinear on the card against float64, forward (two products)
        # and inverse (two triangular solves), uncached and cached: the 1e-4
        # class of 1 + |f64|; TF32, which would put products 1e-3 off, is off
        # by PyTorch's default, which this script also sets (phase 1)
        xs = 2.0 * torch.randn(SERVE_BATCH, D, generator=g).to(dev)
        lu_err = 0.0
        for i, m in enumerate(lus):
            m64 = copy.deepcopy(m).double()
            want = (m64(xs.double()), m64.inverse(xs.double()))
            for cached in (False, True):
                mc = copy.deepcopy(m).precompute() if cached else m
                got = (mc(xs), mc.inverse(xs))
                e = [relative(a, b) for pair in zip(got, want) for a, b in zip(*pair)]
                lu_err = max(lu_err, *e)
                log(f"  LULinear {i}{' cached' if cached else ''} against float64, relative to "
                    "1 + |f64|: forward out {:.3e} lad {:.3e}, inverse out {:.3e} lad {:.3e}"
                    .format(*e))
        ok = lu_err <= 1e-4
        log(f"  the LU layers' largest relative error {lu_err:.3e} (limit 1e-4; "
            f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32})  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError("an LULinear on the card is past 1e-4 of float64")
        stats["LU against float64"] = lu_err
    # 15 transforms: the AR prober's first check
    refused("NSF-AR with LU layers", lu_flow, D, "expected [permutation, affine-AR] pairs")
    x_lu, lp_lu, first, second = serve_a6("NSF-AR with LU layers", lu_flow, D, {"B1": L},
                                          {"B1": L * D}, 512)
    b1_keys.update(a6_launches=first["B1"], a6_sample_launches=second["B1"])
    cached_flow = precompute_linear_caches(copy.deepcopy(lu_flow))
    _, lp_cached, _, _ = serve_a6("NSF-AR with LU layers, cached", cached_flow, D, {"B1": L},
                                  {"B1": L * D}, 512, calls=5, x=x_lu)
    gap = relative(lp_cached, lp_lu)
    log(f"  cached against uncached log_prob: {gap:.3e} of 1 + |log_prob| (limit 1e-4)")
    if not gap <= 1e-4:
        raise AssertionError("the cached LU layers disagree with the uncached ones")
    train_a6("NSF-AR with LU layers", lu_flow, D, {"B1": L})
    # windows of 8 steps against the per-step loop from identical state: the
    # first runs the two warm-up steps and captures a graph of the other 6,
    # the second captures a graph of 8, the third replays it (no launch)
    adam_c = lambda prm: torch.optim.Adam(prm, lr=3e-4, capturable=True)  # noqa: E731
    S = _window.GRAPH_STEPS
    wg = torch.Generator(device=dev).manual_seed(35)
    data = 1.5 * torch.randn(S, TRAIN_BATCH, D, generator=wg, device=dev) + 0.5
    twin = create_train_state(copy.deepcopy(lu_flow).train(), adam_c)
    eager_step = make_train_step()
    loop = torch.stack([eager_step(twin, data[i % S])[1]["loss"] for i in range(3 * S)])
    state = create_train_state(copy.deepcopy(lu_flow).train(), adam_c)
    steps = make_scan_train_step()
    windows, launched = [], []
    for expected in (L * S, L * S, 0):
        counts.reset()
        state, losses = steps(state, data)
        torch.cuda.synchronize()
        launched.append(counts.read())
        windows.append(losses)
        counts.expect(f"window {len(windows)} of the NSF-AR with LU layers", launched[-1],
                      B1=expected)
    windows = torch.cat(windows)
    same = torch.equal(windows, loop)
    log(f"NSF-AR with LU layers, three windows of {S} steps at {TRAIN_BATCH} against the "
        f"per-step loop: {max_err(windows, loop):.3e} apart, bit-equal {same} (limit: "
        "bit-equal, as phase 33's eager window); launches "
        + ", ".join(str({a: b for a, b in c.items() if b}) for c in launched)
        + f"; graphs held {steps.window.captured}")
    if not same or not bool(torch.isfinite(loop).all()):
        raise AssertionError("the NSF-AR-LU window disagrees with the per-step loop")
    stats["NSF-AR with LU layers, windows"] = dict(gap=max_err(windows, loop))
    del steps, state, twin

    # (b) the flagship with batch statistics inside its conditioners
    bn_nsf = NeuralSplineFlow(**FLAGSHIP, batch_norm_within_layers=True,
                              generator=torch.Generator().manual_seed(36),
                              rng=np.random.default_rng(36), device=dev)
    refused("batch-normed flagship", bn_nsf, FD, "batch-norm/dropout conditioners not fused")
    _, _, first, _ = serve_a6("batch-normed flagship", bn_nsf, FD, {"B1": FL}, {"B1": FL},
                              SERVE_BATCH)
    b1_keys["a6_flagship_bn_launches"] = first["B1"]
    train_a6("batch-normed flagship", bn_nsf, FD, {"B1": FL})

    # (c) the MAF with BatchNorm between its layers and batch statistics in
    # its MADEs: final MADE weights x 0.1 as phase 9's (an untamed full-width
    # MAF's fixed point is ill-conditioned); statistics from a batch, then
    # eval mode; no kernel runs
    bn_maf = MaskedAutoregressiveFlow(**MAF, batch_norm_between_layers=True,
                                      batch_norm_within_layers=True,
                                      generator=torch.Generator().manual_seed(37),
                                      rng=np.random.default_rng(37), device=dev)
    with torch.no_grad():
        for t in bn_maf.transform.transforms:
            net = getattr(t, "autoregressive_net", None)
            if net is not None:
                net.final_layer.weight.mul_(0.1)
    refused("batch-normed MAF", bn_maf, D, "expected [permutation, affine-AR] pairs")
    served = CompiledFlow(bn_maf, batch_size=SERVE_BATCH, features=D, num_samples=512)
    try:
        served.sample(torch.Generator(device=dev).manual_seed(0))
    except InverseNotAvailable:
        log("batch-normed MAF in training mode: a sample request raises InverseNotAvailable")
    else:
        raise AssertionError("a training-mode BatchNorm sampled")
    with torch.no_grad():
        bn_maf.transform.initialize_with_data(
            1.5 * torch.randn(SERVE_BATCH, D, generator=g).to(dev) + 0.5)
    serve_a6("batch-normed MAF", bn_maf.eval(), D, {}, {}, SERVE_BATCH, kernel=False)
    train_a6("batch-normed MAF", bn_maf, D, {})

    seconds = time.perf_counter() - t_a6
    log(f"queue A6: {json.dumps(stats)}")
    log(f"phase 35 (the transforms of queue A6) took {seconds:.1f} s")
    return b1_keys, stats


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from nflows_tpu_torch import (
        CompiledFlow,
        InverseAutoregressiveFlow,
        MADEMoG,
        MaskedAutoregressiveFlow,
        MixtureOfGaussiansMADE,
        NeuralSplineFlow,
        NeuralSplineFlowAR,
        create_train_state,
        fused_trainer,
        make_train_step,
    )
    from nflows_tpu_torch.ops.cuda import (
        _build,
        cubic_spline,
        linear_spline,
        lrs_spline,
        mademog_fused,
        mademog_train,
        maf_flow_kernel,
        maf_fused,
        maf_train,
        nsf_flow_kernel,
        nsf_fused,
        nsf_train,
        quadratic_spline,
        rq_spline,
    )
    from nflows_tpu_torch.ops.cuda.maf_fused import _extract as extract_maf
    from nflows_tpu_torch.ops.cuda.maf_fused import fuse_maf
    from nflows_tpu_torch.ops.cuda.nsf_fused import fuse_nsf
    from nflows_tpu_torch.training.fused import MIN_AUTO_BATCH
    from nflows_tpu_torch.ops.splines import rational_quadratic as rq
    from nflows_tpu_torch.ops.splines import cubic, linear, linear_rational, quadratic

    # -- phase 1: device and settings ----------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    # -- phase 2: build -------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    for stem, text in sorted(_build.BUILD_LOG.items()):
        serialized = {}
        for line in text.splitlines():
            if "(C75" not in line and ("registers" in line or "spill" in line):
                log(f"  {stem}: {line.strip()}")
            elif "(C75" in line:
                # ptxas's notes on wgmma (C7511, C7515, C7519, C7520), counted
                # by note and kernel
                code = line.split("(C75", 1)[1][:2]
                kernel = line.rsplit("'", 2)[-2] if line.count("'") >= 2 else "?"
                key = (f"C75{code}", kernel)
                serialized[key] = serialized.get(key, 0) + 1
        for (code, kernel), count in sorted(serialized.items()):
            log(f"  {stem}: {code} x{count} in {kernel}")

    # -- phase 3: B1 against its plain version ---------------------------------
    flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                            rng=np.random.default_rng(0), device=dev, **FLAGSHIP)
    flow.eval()
    K, B = FLAGSHIP["num_bins"], FLAGSHIP["tail_bound"]
    D = FLAGSHIP["features"]
    gen = torch.Generator().manual_seed(0)
    b1 = {}
    with torch.no_grad():
        for samples in (SERVE_BATCH, (1 << 20) // 3):
            args = family_inputs("rq", flow, torch.randn(samples, D, generator=gen).to(dev))
            args[0].view(-1)[:4] = torch.tensor([B, -B, B + 0.5, -B - 0.5])
            stress = [args[0], *(torch.randn(t.shape, generator=gen).to(dev)
                                 for t in args[1:])]
            n = args[0].numel()
            log(f"B1 at {n} elements (flagship coupling 1, then N(0,1) parameters):")
            errs, stats = [], {}
            for inverse in (False, True):
                kw = dict(inverse=inverse, tail_bound=B)
                tag = "inverse" if inverse else "forward"
                out, lad = rq_spline.rq_spline_cuda(*args, **kw)
                p_out, p_lad = rq.unconstrained_rational_quadratic_spline_plain(*args, **kw)
                d_out, d_lad = rq.unconstrained_rational_quadratic_spline_plain(
                    *[t.double() for t in args], **kw)
                torch.cuda.synchronize()
                errs.append(hold(f"{tag} out", out, p_out, d_out, 1e-4))
                errs.append(hold(f"{tag} lad", lad, p_lad, d_lad, 1e-3))
                out, lad = rq_spline.rq_spline_cuda(*stress, **kw)
                p_out, p_lad = rq.unconstrained_rational_quadratic_spline_plain(*stress, **kw)
                d_out, d_lad = rq.unconstrained_rational_quadratic_spline_plain(
                    *[t.double() for t in stress], **kw)
                torch.cuda.synchronize()
                hold_exact(f"stress {tag} out", out, p_out, d_out, 1e-2)
                hold_exact(f"stress {tag} lad", lad, p_lad, d_lad, 1e-2)
                run = lambda: rq_spline.rq_spline_cuda(*args, **kw)  # noqa: E731
                run_plain = lambda: rq.unconstrained_rational_quadratic_spline_plain(  # noqa: E731
                    *args, **kw)
                ms = device_ms(torch, run, 100, kernel="rq_spline_kernel")
                ms_source = device_ms.source
                plain_ms = device_ms(torch, run_plain, 10)
                log(f"  {tag} a call, events: kernel {call_ms(torch, run, 100):.4f} ms  "
                    f"plain {call_ms(torch, run_plain, 10):.4f} ms")
                nbytes = 4 * n * (1 + 2 * K + (K - 1) + 2)  # x, widths, heights, derivs; out, lad
                nops = n * (12 * K + 60)                     # compares, exps, sums, RQ evaluation
                bound_ms = 1e3 * max(nbytes / PEAK_BYTES, nops / PEAK_FP32_FLOPS)
                bound_by = ("bytes" if nbytes / PEAK_BYTES >= nops / PEAK_FP32_FLOPS
                            else "operations")
                log(f"  {tag} time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                    f"{bound_ms:.5f} ms ({bound_by})")
                pre = "inverse_" if inverse else ""
                stats.update({pre + "ms": ms, pre + "ms_source": ms_source,
                              pre + "plain_ms": plain_ms, pre + "bound_ms": bound_ms,
                              pre + "bound_by": bound_by})
            b1[n] = dict(err=max(errs), **stats)
    # the card's floor for one launch, a one-element fill (as device_ms pads
    # its traces with), read once the card runs at its clocks under load:
    # after an idle spell the fill read twice as long
    pad = torch.empty(1, device=dev)
    launch_floor_ms = device_ms(torch, pad.zero_, 100)
    log(f"one launch's floor (a one-element fill): {launch_floor_ms:.5f} ms, beside B1's bounds "
        + ", ".join(f"{b1[n]['bound_ms']:.5f} at {n}" for n in b1))
    for n in list(b1):
        b1[n]["launch_floor_ms"] = launch_floor_ms
    # every group layout of B1 (csrc/spline_lanes.cuh): 2 to 32 lanes of 4
    # bins, chunks past 128 bins, one round a warp and full warps of rounds
    b1["layouts_err"] = hold_layouts(torch, "B1", rq_spline.rq_spline_cuda,
                                     rq.unconstrained_rational_quadratic_spline_plain,
                                     lambda k: (k, k, k - 1), B1_LAYOUT_BINS, dev)

    # -- phase 4: B2 against its plain version (full-width flagship) -----------
    # both routes: the tensor-core kernel (csrc/nsf_flow_wgmma.cu, the route
    # this shape takes) and the SIMT one (csrc/nsf_flow_kernel.cu), each held
    # to the plain version and timed in the same run; first one GEMM alone
    # through the wgmma route's ring (gemm_wgmma) against gemm()
    B2_KERNEL = {"wgmma": "nsf_flow_wgmma_kernel", "simt": "nsf_flow_kernel"}

    def b2_routes(weights, indices, spline):
        """The route B2 takes for these weights (of family ``spline``), and
        beside it the other route where the shape can take the wgmma one
        (the SIMT kernel, or the wgmma kernel forced on an fp32 affine
        chain, which keeps the SIMT route)."""
        route = nsf_flow_kernel.weights_route(weights, indices, spline=spline)
        if nsf_flow_kernel.weights_route(weights, indices) != "wgmma":
            return (route,)
        return (route, "simt" if route == "wgmma" else "wgmma")

    def b2_bound(nops, nbytes, route, dtype=torch.float32):
        """B2's least time on its route: the operations on the units that
        route runs them on (bf16: the bf16 tensor cores; fp32 on wgmma:
        3xTF32, three TF32 products a product, on the TF32 tensor cores;
        the SIMT route: fp32 on the CUDA cores), or the bytes; with the
        CUDA-core bound beside it."""
        io_ms = 1e3 * nbytes / PEAK_BYTES
        core_ms = 1e3 * nops / PEAK_FP32_FLOPS
        if dtype == torch.bfloat16:
            ops_ms, basis = 1e3 * nops / PEAK_BF16_FLOPS, "bf16 tensor cores, 989 TFLOP/s"
        elif route == "wgmma":
            ops_ms = 1e3 * 3 * nops / PEAK_TF32_FLOPS
            basis = "3xTF32: three TF32 products each, 495 TFLOP/s"
        else:
            ops_ms, basis = core_ms, "fp32 on the CUDA cores, 67 TFLOP/s"
        return dict(bound_ms=max(ops_ms, io_ms),
                    bound_by="operations" if ops_ms >= io_ms else "bytes",
                    bound_basis=basis, cuda_core_bound_ms=max(core_ms, io_ms))

    gemm_gen = torch.Generator().manual_seed(4)
    log("one GEMM through the wgmma route's ring against gemm():")
    for wdt in (torch.float32, torch.bfloat16):
        for rows_g, depth, outs in ((RAGGED, 256, 256), (SERVE_BATCH, 16, 256),
                                    (SERVE_BATCH, 256, 128)):
            a = torch.randn(rows_g, depth, generator=gemm_gen).to(dev)
            wm = (torch.randn(outs, depth, generator=gemm_gen) / 16).to(dev).to(wdt)
            got = nsf_flow_kernel.gemm_wgmma(a, wm)
            plain32 = nsf_flow_kernel.gemm(a, wm)
            exact = nsf_flow_kernel.gemm(a.double(), wm.double()) if wdt == torch.float32 \
                else nsf_flow_kernel.gemm(a, wm).double()
            torch.cuda.synchronize()
            hold(f"{str(wdt)[6:]} [{rows_g}, {depth}] x [{outs}, {depth}]^T", got, plain32,
                 exact, 1e-5 * float(exact.abs().max()))

    fused = fuse_nsf(flow)
    static, idx = fused._static, fused._indices
    w32 = fused._weights
    w64 = {k: v.double() for k, v in w32.items()}
    L, H = FLAGSHIP["num_layers"], FLAGSHIP["hidden_features"]
    Tid, T = len(idx[0].id_idx), len(idx[0].tr_idx)
    TM = T * (3 * K - 1)
    nb = FLAGSHIP["num_blocks_per_layer"]
    weight_bytes = 4 * sum(v.numel() for v in w32.values())
    flagship_routes = b2_routes(w32, idx, static["spline"])
    b2 = {}
    for n in (SERVE_BATCH, 1 << 16, RAGGED):
        # the ragged N from a generator of its own: the shared one draws
        # for every later phase what it drew before this size came
        draw = torch.Generator().manual_seed(n) if n == RAGGED else gen
        x = torch.randn(n, D, generator=draw).to(dev)
        log(f"B2 at N={n}:")
        errs = []
        for gr in flagship_routes:
            for inverse in (False, True):
                kw = dict(inverse=inverse, **static)
                y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, w32, idx, packed=fused._packed,
                                                              gemm=gr, **kw)
                p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, w32, idx, **kw)
                d_y, d_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x.double(), w64, idx, **kw)
                torch.cuda.synchronize()
                if not (torch.isfinite(y).all() and torch.isfinite(lad).all()):
                    raise AssertionError(f"B2 ({gr}) produced non-finite values")
                tag = f"{gr} {'inverse' if inverse else 'forward'}"
                errs.append(hold(f"{tag} out", y, p_y, d_y, 1e-3))
                errs.append(hold(f"{tag} lad", lad, p_lad, d_lad, 1e-3))
        if n == RAGGED:
            continue
        kw = dict(inverse=False, **static)
        times = {}
        for gr in flagship_routes:
            run = lambda: nsf_flow_kernel.nsf_flow_kernel_cuda(  # noqa: E731
                x, w32, idx, packed=fused._packed, gemm=gr, **kw)  # noqa: B023
            times[gr] = (device_ms(torch, run, 10, kernel=B2_KERNEL[gr]), device_ms.source)
            log(f"  {gr}, a call, events: {call_ms(torch, run, 10):.4f} ms")
        run_plain = lambda: nsf_flow_kernel.nsf_flow_kernel_plain(x, w32, idx, **kw)  # noqa: E731
        plain_ms = device_ms(torch, run_plain, 5)
        ms, ms_source = times[flagship_routes[0]]
        nops = 2 * n * L * (Tid * H + 2 * nb * H * H + H * TM)
        bnd = b2_bound(nops, weight_bytes + 4 * n * (2 * D + 1), flagship_routes[0])
        log(f"  time: {flagship_routes[0]} kernel {ms:.4f} ms"
            + (f", simt kernel {times['simt'][0]:.4f} ms" if "simt" in times
               and flagship_routes[0] != "simt" else "")
            + f"  plain {plain_ms:.4f} ms  bound {bnd['bound_ms']:.4f} ms ({bnd['bound_by']}, "
            f"{bnd['bound_basis']}; CUDA cores {bnd['cuda_core_bound_ms']:.4f})  "
            f"{nops / 1e9:.1f} GFLOP, {nops / ms / 1e9:.1f} TFLOP/s")
        b2[n] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                     gemm_route=flagship_routes[0], simt_ms=times["simt"][0], **bnd)

    # -- phase 5: serving through CompiledFlow ---------------------------------
    def reset_counts():
        rq_spline.launch_count = 0
        nsf_flow_kernel.launch_count = 0
        nsf_train.loss_grad_launch_count = 0
        nsf_train.bwd_launch_count = 0
        maf_flow_kernel.launch_count = 0
        maf_flow_kernel.degree_launch_count = 0
        mademog_fused.launch_count = 0
        for module in (lrs_spline, linear_spline, quadratic_spline, cubic_spline):
            module.launch_count = 0
        for module in (nsf_flow_kernel, maf_flow_kernel, mademog_fused):
            module.bf16_launch_count = 0
        for module in (nsf_flow_kernel, maf_flow_kernel, mademog_fused):
            for route in module.route_launch_count:
                module.route_launch_count[route] = 0
        for module in (maf_train, mademog_train):
            for cs in module.cluster_launch_count:
                module.cluster_launch_count[cs] = 0

    def read_counts():
        return {"B1": rq_spline.launch_count, "B2": nsf_flow_kernel.launch_count,
                "B3": nsf_train.loss_grad_launch_count, "B4": nsf_train.bwd_launch_count,
                "B9": maf_flow_kernel.launch_count, "B10": maf_train.bwd_launch_count,
                "B11": mademog_fused.launch_count, "B12": mademog_train.bwd_launch_count,
                "B5": lrs_spline.launch_count, "B6": linear_spline.launch_count,
                "B7": quadratic_spline.launch_count, "B8": cubic_spline.launch_count,
                "B2_bf16": nsf_flow_kernel.bf16_launch_count,
                "B9_bf16": maf_flow_kernel.bf16_launch_count,
                "B9_degree": maf_flow_kernel.degree_launch_count,
                "B11_bf16": mademog_fused.bf16_launch_count,
                **{f"B2_{route}": c for route, c in nsf_flow_kernel.route_launch_count.items()},
                **{f"B9_{route}": c for route, c in maf_flow_kernel.route_launch_count.items()},
                **{f"B11_{route}": c for route, c in mademog_fused.route_launch_count.items()}}

    def b2_route_counts(server, requests=1):
        """The route counters a fused B2 request of ``server`` must move: its
        weights' route (B2_wgmma, B2_simt and their _bf16 twins), once a
        request; none for another model."""
        view = server._fused
        if not isinstance(view, nsf_fused.FusedNSF):
            return {}
        route = nsf_flow_kernel.weights_route(view._weights, view._indices,
                                              spline=view._static["spline"])
        bf16 = view._weights["w0"].dtype == torch.bfloat16
        return {f"B2_{route}{'_bf16' if bf16 else ''}": requests}

    def b9_route_counts(server, direction, requests=1):
        """The counters ``requests`` fused B9 requests of ``server`` in
        ``direction`` ("log_prob" or "sample") must move beside B9's total:
        the one-pass route of its weights (B9_wgmma, B9_simt and their _bf16
        twins) where every layer runs one pass that way, else the degree
        kernel; none for another model."""
        view = server._fused
        if not isinstance(view, maf_fused.FusedMAF):
            return {}
        bf16 = view._weights["wi"].dtype == torch.bfloat16
        if not maf_flow_kernel.one_pass(view._static, direction == "sample"):
            if view._packed["degrees"] is None:
                return {f"B9_simt{'_bf16' if bf16 else ''}": requests}
            return {"B9_degree": requests}
        route = maf_flow_kernel.weights_route(view._weights, view._static, view._num_blocks)
        return {f"B9_{route}{'_bf16' if bf16 else ''}": requests}

    def b11_route_counts(server, requests=1):
        """The route counters ``requests`` fused B11 requests of ``server``
        must move beside B11's total: its weights' route (B11_wgmma,
        B11_simt and their _bf16 twins); none for another model."""
        view = server._fused
        if not isinstance(view, mademog_fused.FusedMADEMoG) or not requests:
            return {}
        route = mademog_fused.weights_route(view._weights, view._static)
        bf16 = view._weights["wi"].dtype == torch.bfloat16
        return {f"B11_{route}{'_bf16' if bf16 else ''}": requests}

    def b10_layouts():
        """B10's launches since the last reset by cluster size (1: one block
        a tile, csrc/maf_train.cu; 2, 4, 8: csrc/maf_train_cluster.cu)."""
        return {cs: c for cs, c in maf_train.cluster_launch_count.items() if c}

    def expect_counts(what, counts, **expected):
        expected = {**{k: 0 for k in counts}, **expected}
        if counts != expected:
            raise AssertionError(f"{what} launched {counts}, expected {expected}")

    launches = {}
    context_launches = {}  # launches a request or step on the conditional paths
    serve_times = {}       # "model, path, endpoint" -> a request's wall and busy ms

    def serve(model, flow, features, fused_kernel, unfused_log_prob, unfused_sample,
              fused_sample=None, context_features=None, context_rows=None, ties=0, draw=None):
        """Serve ``flow`` through CompiledFlow on both paths: a log_prob
        request, then the two sampling requests, with the launches of each
        counted from zero; ``fused_kernel`` must run once a fused log_prob
        request and ``fused_sample`` (default: twice) in the two sampling
        requests, and the unfused path must launch exactly
        ``unfused_log_prob`` / ``unfused_sample`` a request. A conditional
        model's log_prob takes a context row a sample; it is sampled one
        sample a context row, or, with ``context_rows``, SERVE_BATCH /
        context_rows samples for each of that many rows, and then the two
        paths' samples must agree too (one generator gives both the same
        noise). ``ties``: samples that may miss the consistency limit, for a
        density that is piecewise constant (the linear spline's): a sample
        whose inverse lands within rounding of a bin edge takes the
        neighbouring bin's density on the way back. ``draw``: the generator
        of the inputs (default: the shared one). A fused B9 request also
        moves its route's counter or the degree kernel's
        (``b9_route_counts``), a fused B11 request its (``b11_route_counts``).
        Each endpoint's wall and device busy time go to ``serve_times``."""
        draw = gen if draw is None else draw
        x = torch.randn(SERVE_BATCH, features, generator=draw).to(dev)
        ctx = (None if context_features is None
               else torch.randn(SERVE_BATCH, context_features, generator=draw).to(dev))
        rows = context_rows or SERVE_BATCH
        few = ctx if context_rows is None else torch.randn(rows, context_features,
                                                           generator=draw).to(dev)
        rep = ctx if context_rows is None else few.repeat_interleave(SERVE_BATCH // rows, 0)
        kw = dict(features=features, context_features=context_features)
        lp_kw = dict(batch_size=SERVE_BATCH, num_samples=None if ctx is None else 1)
        out = {}
        book = launches if context_features is None else context_launches
        for name, use_fused in (("fused", True), ("unfused", False)):
            # the fused path as a user gets it: CompiledFlow's own choice
            kw["use_fused"] = None if use_fused else False
            server = CompiledFlow(flow, **kw, **lp_kw)
            sampler = server if context_rows is None else CompiledFlow(
                flow, batch_size=rows, num_samples=SERVE_BATCH // rows, **kw)
            if server.is_fused != use_fused or sampler.is_fused != use_fused:
                raise AssertionError(f"{model}: CompiledFlow did not take the {name} path")
            g = torch.Generator(device=dev).manual_seed(1)
            reset_counts()
            lp = server.log_prob(x, ctx)
            torch.cuda.synchronize()
            first = read_counts()
            reset_counts()
            s = sampler.sample(g, few).reshape(SERVE_BATCH, features)
            s2, lp2 = sampler.sample_and_log_prob(g, few)
            s2, lp2 = s2.reshape(SERVE_BATCH, features), lp2.reshape(SERVE_BATCH)
            torch.cuda.synchronize()
            rest = read_counts()
            log(f"serving {model} ({name}): launches a request {first}, two more requests "
                f"{rest}")
            if use_fused:
                expect_counts(f"one fused {model} request", first, **{fused_kernel: 1},
                              **b2_route_counts(server), **b9_route_counts(server, "log_prob"),
                              **b11_route_counts(server))
                expect_counts(f"two fused {model} requests", rest,
                              **(fused_sample or {fused_kernel: 2}),
                              **b2_route_counts(sampler, 2),
                              **b9_route_counts(sampler, "sample", 2),
                              **b11_route_counts(sampler, (fused_sample or {}).get("B11", 0)))
                book.setdefault(fused_kernel, first[fused_kernel])
                for kid in ("B9_degree", "B9_wgmma", "B11_wgmma"):
                    # B9's fixed point on the degree kernel, its one pass on
                    # the tensor cores: once a request
                    if first[kid] or rest[kid]:
                        book.setdefault(kid, first[kid] or rest[kid] // 2)
            else:
                expect_counts(f"one unfused {model} request", first, **unfused_log_prob)
                expect_counts(f"two unfused {model} requests", rest,
                              **{k: 2 * v for k, v in unfused_sample.items()})
                for kid in unfused_log_prob:
                    book.setdefault(kid, first[kid])
            for t, shape in ((lp, (SERVE_BATCH,)), (s, (SERVE_BATCH, features)),
                             (s2, (SERVE_BATCH, features)), (lp2, (SERVE_BATCH,))):
                if tuple(t.shape) != shape or not torch.isfinite(t).all():
                    raise AssertionError(f"{model} {name}: bad output {tuple(t.shape)}")
            gaps = (lp2.double() - server.log_prob(s2, rep).double()).abs().flatten()
            consistency = float(gaps.max())
            over = int((gaps > 5e-3).sum())
            rest_max = float(gaps.sort().values[-1 - ties]) if ties else consistency
            log(f"  sample_and_log_prob vs log_prob(samples): {consistency:.3e} (limit 5e-3"
                + (f"; {over} bin-edge ties allowed up to {ties}, the rest {rest_max:.3e})"
                   if ties else ")"))
            if over > ties:
                raise AssertionError(
                    f"{model} {name}: sample_and_log_prob disagrees with log_prob")
            out[name] = (lp, s, s2, lp2)
            for endpoint, fn in (("log_prob", lambda: server.log_prob(x, ctx)),  # noqa: B023
                                 ("sample", lambda: sampler.sample(  # noqa: B023
                                     torch.Generator(device=dev).manual_seed(2), few))):
                fn()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(10):
                    fn()
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / 10
                # the unfused path's profile holds thousands of launches a call:
                # fewer calls keep its cost to the run down
                busy = device_ms(torch, fn, 10 if use_fused else 3)
                log(f"  {endpoint}: {wall:.3f} ms a request of {SERVE_BATCH} (host clock), "
                    f"device busy {busy:.3f} ms")
                serve_times[f"{model}, {name}, {endpoint}"] = dict(wall_ms=wall, busy_ms=busy)
        compared = ("log_prob", "samples", "more samples", "their log_prob")
        for i, what in enumerate(compared[:1] if context_rows is None else compared):
            gap = max_err(out["fused"][i], out["unfused"][i])
            log(f"  unfused vs fused {what}: {gap:.3e} (limit 1e-3)")
            if gap > 1e-3:
                raise AssertionError(f"{model}: unfused and fused {what} disagree")

    serve("NSF", flow, D, "B2", dict(B1=L), dict(B1=L))

    # -- phase 6: B3 and B4 against their plain versions (full-width flagship) ----
    def hold_training_kernels(trainer, batches_n, every_cluster=False, fresh=(2048,),
                              plain_sizes=None):
        """B3 and B4 on ``trainer``'s weights against their plain versions at
        each batch size (with a context of N(0, 1) rows where the trainer's
        flow has one), at the cluster size the wrapper chooses and at every
        other one its 32-sample tiles can take (csrc/nsf_train.cu and
        csrc/nsf_train_cluster.cu): errors, times and bounds by batch, for
        each kernel, the chosen cluster size's time beside one block a
        tile's, and with ``every_cluster`` each cluster size's time. The
        inputs at the sizes in ``fresh`` come from a generator of their own
        (seeded with the size), so that the shared one draws what it drew
        before those sizes were added. The plain versions are timed at the
        sizes in ``plain_sizes`` (default: every size), their holds at
        every size."""
        tw32 = {k: v.detach() for k, v in trainer.weights.items()}
        tw64 = {k: v.double() for k, v in tw32.items()}
        tidx = trainer._indices
        d = trainer._dims
        stacks = tuple(tw32)
        w_bytes = 4 * sum(v.numel() for v in tw32.values())
        C = d["C"]
        out3, out4 = {}, {}
        for n in batches_n:
            draw = torch.Generator().manual_seed(n) if n in fresh else gen
            x = (1.5 * torch.randn(n, d["D"], generator=draw)).to(dev)
            ctx = torch.randn(n, C, generator=draw).to(dev) if C else None
            tkw = dict(wh_scale=trainer._wh_scale, context=ctx, **trainer._static)
            dkw = dict(tkw, context=None if ctx is None else ctx.double())
            nops = 3 * 2 * n * d["L"] * (d["Tid"] * d["H"] + C * d["H"] + d["nb2"] * d["H"] ** 2
                                         + d["nb2"] // 2 * C * d["H"] + d["H"] * d["TM"])
            rows, chosen, grid = nsf_train.launch_layout(True, n, d, dev)
            others = [c for c in (1, *nsf_train.CLUSTER_SIZES) if c != chosen and rows == 32]
            active = {c: nsf_train.active_clusters(
                dev, True, C, c, nsf_train.shared_memory_bytes(
                    rows, d["D"], d["L"], d["H"], d["Tid"], d["T"], d["TM"], C, c))
                for c in nsf_train.CLUSTER_SIZES} if rows == 32 else {}
            log(f"B3 at N={n}" + (f", context {C}" if C else "") + f": {-(-n // rows)} tiles of "
                f"{rows} samples, cluster size {chosen} (grid {grid}); active clusters by size "
                f"{active}")
            loss, lp, grads = nsf_train.nsf_loss_grad_cuda(x, tw32, tidx, **tkw)
            p_loss, p_lp, p_grads = nsf_train.nsf_loss_grad_plain(x, tw32, tidx, **tkw)
            d_loss, d_lp, d_grads = nsf_train.nsf_loss_grad_plain(x.double(), tw64, tidx, **dkw)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in (loss, lp, *grads.values())):
                raise AssertionError("B3 produced non-finite values")
            errs = [hold("loss", loss, p_loss, d_loss, 1e-4), hold("lp", lp, p_lp, d_lp, 1e-3)]
            errs += [hold(f"g{k}", grads[k], p_grads[k], d_grads[k], 2e-4) for k in stacks]
            for c in others:
                log(f"  cluster size {c}:")
                c_loss, c_lp, c_grads = nsf_train.nsf_loss_grad_cuda(x, tw32, tidx, rows=rows,
                                                                    cluster=c, **tkw)
                torch.cuda.synchronize()
                errs += [hold("  loss", c_loss, p_loss, d_loss, 1e-4),
                         hold("  lp", c_lp, p_lp, d_lp, 1e-3)]
                errs += [hold(f"  g{k}", c_grads[k], p_grads[k], d_grads[k], 2e-4)
                         for k in stacks]
            first = {k: v.clone() for k, v in grads.items()}
            _, _, again = nsf_train.nsf_loss_grad_cuda(x, tw32, tidx, grads=grads, **tkw)
            torch.cuda.synchronize()
            drift = max(max_err(again[k], first[k]) for k in stacks)
            log(f"  a second launch into the same buffers moves a gradient by {drift:.3e} at "
                "most (limit 1e-5 + 1e-4 relative)")
            if not all(torch.allclose(again[k], first[k], atol=1e-5, rtol=1e-4) for k in stacks):
                raise AssertionError("B3: a second launch added to the first one's gradients")
            packed = nsf_flow_kernel.pack_weights(tw32, tidx)

            def cluster_times(kernel, name):
                """The kernel's time at one block a tile and, with
                ``every_cluster``, at each cluster size: {CS: ms}."""
                return {c: device_ms(torch, lambda: kernel(c), 10, kernel=name)  # noqa: B023
                        for c in ([1] if every_cluster else [1] if chosen != 1 else [])
                        + (list(nsf_train.CLUSTER_SIZES) if every_cluster and rows == 32
                           else [])}

            run = lambda: nsf_train.nsf_loss_grad_cuda(  # noqa: E731
                x, tw32, tidx, packed=packed, grads=grads, **tkw)
            run_plain = lambda: nsf_train.nsf_loss_grad_plain(x, tw32, tidx, **tkw)  # noqa: E731
            ms = device_ms(torch, run, 10, kernel="nsf_loss_grad")
            ms_source = device_ms.source
            by_cluster = cluster_times(lambda c: nsf_train.nsf_loss_grad_cuda(
                x, tw32, tidx, packed=packed, grads=grads, rows=rows, cluster=c, **tkw),
                "nsf_loss_grad")
            timed_plain = plain_sizes is None or n in plain_sizes
            plain_ms = device_ms(torch, run_plain, 3) if timed_plain else None
            nbytes = 2 * w_bytes + 4 * n * (d["D"] + 1 + C)
            bound_ms = 1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
            bound_by = "operations" if nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
            log(f"  time: kernel {ms:.4f} ms (cluster size {chosen})  plain "
                + ("not timed" if plain_ms is None else f"{plain_ms:.4f} ms")
                + f"  bound {bound_ms:.4f} ms ({bound_by}, {nops / 1e9:.1f} GFLOP)  "
                f"{nops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound; by "
                f"cluster size {json.dumps({c: round(t, 4) for c, t in by_cluster.items()})}")
            out3[n] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, cluster_size=chosen,
                           ms_by_cluster_size=by_cluster, active_clusters=active)

            log(f"B4 at N={n}:")
            gy = (torch.randn(n, d["D"], generator=draw) / n).to(dev)
            glad = (torch.randn(n, generator=draw) / n).to(dev)
            gx, grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, tw32, tidx, **tkw)
            p_gx, p_grads = nsf_train.nsf_train_bwd_plain(x, gy, glad, tw32, tidx, **tkw)
            d_gx, d_grads = nsf_train.nsf_train_bwd_plain(
                x.double(), gy.double(), glad.double(), tw64, tidx, **dkw)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in (gx, *grads.values())):
                raise AssertionError("B4 produced non-finite values")
            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")
            errs = [hold("gx * N", gx * n, p_gx * n, d_gx * n, 5e-3)]
            if C:
                errs.append(hold("gctx * N", grads["ctx"] * n, p_grads["ctx"] * n,
                                 d_grads["ctx"] * n, 5e-3))
            errs += [hold(f"g{k}", grads[k], p_grads[k], d_grads[k], 2e-4) for k in stacks]
            for c in others:
                log(f"  cluster size {c}:")
                c_gx, c_grads = nsf_train.nsf_train_bwd_cuda(x, gy, glad, tw32, tidx, rows=rows,
                                                             cluster=c, **tkw)
                torch.cuda.synchronize()
                errs.append(hold("  gx * N", c_gx * n, p_gx * n, d_gx * n, 5e-3))
                if C:
                    errs.append(hold("  gctx * N", c_grads["ctx"] * n, p_grads["ctx"] * n,
                                     d_grads["ctx"] * n, 5e-3))
                errs += [hold(f"  g{k}", c_grads[k], p_grads[k], d_grads[k], 2e-4)
                         for k in stacks]
            run = lambda: nsf_train.nsf_train_bwd_cuda(  # noqa: E731
                x, gy, glad, tw32, tidx, packed=packed, grads=grads, **tkw)
            run_plain = lambda: nsf_train.nsf_train_bwd_plain(  # noqa: E731
                x, gy, glad, tw32, tidx, **tkw)
            ms = device_ms(torch, run, 10, kernel="nsf_train_bwd")
            ms_source = device_ms.source
            by_cluster = cluster_times(lambda c: nsf_train.nsf_train_bwd_cuda(
                x, gy, glad, tw32, tidx, packed=packed, grads=grads, rows=rows, cluster=c,
                **tkw), "nsf_train_bwd")
            plain_ms = device_ms(torch, run_plain, 3) if timed_plain else None
            nbytes = 2 * w_bytes + 4 * n * (3 * d["D"] + 1 + 2 * C)
            bound_ms = 1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES)
            bound_by = "operations" if nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES else "bytes"
            log(f"  time: kernel {ms:.4f} ms (cluster size {chosen})  plain "
                + ("not timed" if plain_ms is None else f"{plain_ms:.4f} ms")
                + f"  bound {bound_ms:.4f} ms ({bound_by}, {nops / 1e9:.1f} GFLOP)  "
                f"{nops / ms / 1e9:.1f} TFLOP/s, {100 * bound_ms / ms:.1f}% of the bound; by "
                f"cluster size {json.dumps({c: round(t, 4) for c, t in by_cluster.items()})}")
            out4[n] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by, cluster_size=chosen,
                           ms_by_cluster_size=by_cluster)
        return out3, out4

    TRAIN_SIZES = (TRAIN_BATCH, 2048, SERVE_BATCH)
    b3, b4 = hold_training_kernels(fused_trainer(flow, TRAIN_BATCH), TRAIN_SIZES,
                                   every_cluster=True)

    # the cluster-size rule at narrower widths: B3 and B4 at the training
    # batch on the flagship at hidden 64 and 128 (random weights from seed 0),
    # at one block a tile and at every cluster size, and the size chosen
    by_hidden = {}
    for h in (64, 128):
        tr_h = fused_trainer(NeuralSplineFlow(
            generator=torch.Generator().manual_seed(0), rng=np.random.default_rng(0),
            device=dev, **dict(FLAGSHIP, hidden_features=h)).eval(), TRAIN_BATCH)
        w_h, idx_h = {k: v.detach() for k, v in tr_h.weights.items()}, tr_h._indices
        kw_h = dict(wh_scale=tr_h._wh_scale, packed=nsf_flow_kernel.pack_weights(w_h, idx_h),
                    rows=32, **tr_h._static)
        g_h = torch.Generator().manual_seed(h)
        x_h = (1.5 * torch.randn(TRAIN_BATCH, D, generator=g_h)).to(dev)
        gy_h = (torch.randn(TRAIN_BATCH, D, generator=g_h) / TRAIN_BATCH).to(dev)
        glad_h = (torch.randn(TRAIN_BATCH, generator=g_h) / TRAIN_BATCH).to(dev)
        rows_h, chosen_h, _ = nsf_train.launch_layout(True, TRAIN_BATCH, tr_h._dims, dev)
        times = {}
        for kid, name, call in (
                ("B3", "nsf_loss_grad", lambda c: nsf_train.nsf_loss_grad_cuda(
                    x_h, w_h, idx_h, cluster=c, **kw_h)),  # noqa: B023
                ("B4", "nsf_train_bwd", lambda c: nsf_train.nsf_train_bwd_cuda(
                    x_h, gy_h, glad_h, w_h, idx_h, cluster=c, **kw_h))):  # noqa: B023
            if not all(torch.isfinite(t).all() for t in call(chosen_h)[-1].values()):
                raise AssertionError(f"{kid} produced non-finite values at hidden {h}")
            times[kid] = {c: device_ms(torch, lambda: call(c), 10, kernel=name)  # noqa: B023
                          for c in (1, *nsf_train.CLUSTER_SIZES)}
        by_hidden[h] = dict(rows=rows_h, cluster_size=chosen_h, ms_by_cluster_size=times)
        log(f"B3 and B4 at N={TRAIN_BATCH} on the flagship at hidden {h}: {rows_h}-sample "
            f"tiles, cluster size {chosen_h}; ms by cluster size {json.dumps(times)}")

    # -- phase 7: the trainers on the card --------------------------------------
    import copy

    adam = lambda params: torch.optim.Adam(params, lr=3e-4)  # noqa: E731
    mix = torch.randn(D, D, generator=gen).to(dev) / D ** 0.5

    def batches(n, count, seed):
        """Seeded synthetic data: correlated Gaussian features, scale 1.5."""
        g = torch.Generator(device=dev).manual_seed(seed)
        return [1.5 * torch.randn(n, D, generator=g, device=dev) @ mix + 0.5
                for _ in range(count)]

    def contexts(n, count, seed, context_features):
        """N(0, 1) context rows for ``batches`` (Nones without a context)."""
        if context_features is None:
            return [None] * count
        g = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(n, context_features, generator=g, device=dev) for _ in range(count)]

    def routes(model_flow, n):
        """Fresh trainers of the three routes from ``model_flow``'s initial
        weights: name -> step(batch, context) -> loss, and the objects behind
        them."""
        fused_tr = fused_trainer(copy.deepcopy(model_flow), n)
        split_tr = fused_trainer(copy.deepcopy(model_flow), n)
        split_opt = split_tr.init_opt(adam)
        state = create_train_state(copy.deepcopy(model_flow).train(), adam)
        eager_step = make_train_step()

        def autograd_step(batch, context=None):
            # the composable route: loss_fn under autograd, B2 then B4
            split_opt.zero_grad(set_to_none=True)
            loss = split_tr.loss_fn(split_tr.weights, batch, context)
            loss.backward()
            split_opt.step()
            return loss.detach()

        steps = {
            "fused": fused_tr.make_train_step(fused_tr.init_opt(adam)),
            "fused-autograd": autograd_step,
            "eager": lambda batch, context=None: eager_step(state, batch, context)[1]["loss"],
        }
        return steps, fused_tr, state

    step_busy = {}   # device busy ms a step by (title, route, batch)

    def time_steps(title, make_routes, family, extra, eager_at=(TRAIN_BATCH, SERVE_BATCH)):
        """Time a step of each route at batches 512, 2,048 and 4,096 (the
        eager route at the sizes in ``eager_at``, 512 and 4,096 by default:
        phase 33 measures its host's share at 512 against its window): the wall
        time over 20 steps (the eager route's over 5, each some hundred
        milliseconds) ending in a synchronise, after 3 warm-up steps,
        and the device busy time of one (torch.profiler; three profiled
        steps on the eager route, some thousand launches each).
        ``make_routes(n)`` gives (name -> step, four argument tuples, the
        fused trainer); ``extra(n, trainer, steps, args)`` measures more at
        each size. Logs the batches the fused route wins at beside the
        floor ``fused_trainer(auto=True)`` keeps for ``family``; returns
        the wall times by (route, batch), and keeps the device busy times
        in ``step_busy`` by (title, route, batch)."""
        log(f"{title} step times (host clock over 20 steps, the eager route's over 5, ending "
            "in a synchronise; device busy from torch.profiler; the eager route at "
            + " and ".join(f"{n:,}" for n in eager_at) + "):")
        sizes = (TRAIN_BATCH, 2048, SERVE_BATCH)
        times = {}
        for n in sizes:
            steps, args, trainer = make_routes(n)
            for name, step in steps.items():
                if name == "eager" and n not in eager_at:
                    continue
                for a in args[:3]:
                    step(*a)
                torch.cuda.synchronize()
                reps = 5 if name == "eager" else 20
                t0 = time.perf_counter()
                for i in range(reps):
                    step(*args[i % 4])
                torch.cuda.synchronize()
                wall = 1e3 * (time.perf_counter() - t0) / reps
                busy = device_ms(torch, lambda: step(*args[0]),  # noqa: B023
                                 3 if name == "eager" else 10)
                times[(name, n)] = wall
                step_busy[(title, name, n)] = busy
                log(f"  batch {n} {name}: {wall:.3f} ms a step ({1e3 / wall:.1f} steps/s), "
                    f"device busy {busy:.3f} ms, idle {100 * max(0.0, 1 - busy / wall):.0f}%")
            extra(n, trainer, steps, args)
        faster = [n for n in sizes
                  if ("eager", n) in times and times[("fused", n)] < times[("eager", n)]]
        log(f"  fused faster than eager at batches {faster}; fused_trainer(auto=True) takes "
            f"the fused route from batch {MIN_AUTO_BATCH[family]}")
        return times

    def train_three_routes(model, model_flow, eager_kernels, context_features=None,
                           eager_at=(TRAIN_BATCH, SERVE_BATCH)):
        """Train ``model_flow`` 20 Adam steps on the fused (B3), fused-autograd
        (B2 + B4) and eager routes, the eager one launching ``eager_kernels``
        a step (with a context of ``context_features`` a sample where given);
        check the launches, the first three losses and a falling loss, serve
        the fused-trained flow, then time a step of each route at batches
        512, 2,048 and 4,096 (the eager one at ``eager_at``)."""
        steps, fused_tr, state = routes(model_flow, TRAIN_BATCH)
        data = batches(TRAIN_BATCH, TRAIN_STEPS, seed=3)
        ctxs = contexts(TRAIN_BATCH, TRAIN_STEPS, 13, context_features)
        losses = {}
        # the fused-autograd route's B2 is the SIMT kernel, which reads the
        # layout the trainer re-packs in place after each step
        for name, expected in (("fused", dict(B3=1)),
                               ("fused-autograd", dict(B2=1, B2_simt=1, B4=1)),
                               ("eager", eager_kernels)):
            reset_counts()
            first = steps[name](data[0], ctxs[0])
            torch.cuda.synchronize()
            counts = read_counts()
            log(f"training {model} ({name}): launches a step {counts}")
            expect_counts(f"one {name} step", counts, **expected)
            if name == "fused":
                rows, cs, grid = nsf_train.launch_layout(True, TRAIN_BATCH, fused_tr._dims, dev)
                log(f"  its B3: {rows}-sample tiles on clusters of {cs} blocks, grid {grid}")
            for kid in expected:
                launches.setdefault(kid, counts[kid])
                if context_features is not None:
                    context_launches.setdefault(kid, counts[kid])
            rest = [steps[name](batch, c) for batch, c in zip(data[1:], ctxs[1:])]
            losses[name] = [float(v) for v in [first, *rest]]
            log(f"  {TRAIN_STEPS} Adam steps (lr 3e-4, batch {TRAIN_BATCH}): loss "
                f"{losses[name][0]:.4f} -> {losses[name][-1]:.4f}")
            if not all(np.isfinite(losses[name])) or not losses[name][-1] < losses[name][0]:
                raise AssertionError(f"{model} {name}: the loss is not finite and falling: "
                                     f"{losses[name]}")
        for name in ("fused-autograd", "eager"):
            gap = max(abs(a - b) for a, b in zip(losses["fused"][:3], losses[name][:3]))
            log(f"  first three losses, fused vs {name}: {gap:.3e} apart (limit 2e-3)")
            if gap > 2e-3:
                raise AssertionError(f"{model}: the fused and {name} routes disagree at the "
                                     "start")
        held = batches(TRAIN_BATCH, 1, seed=4)[0]
        held_c = contexts(TRAIN_BATCH, 1, 14, context_features)[0]
        trained = fused_tr.to_flow().eval()
        served_lp = CompiledFlow(trained, batch_size=TRAIN_BATCH, features=D,
                                 context_features=context_features).log_prob(held, held_c)
        _, trainer_lp, _ = nsf_train.nsf_loss_grad_cuda(
            held, fused_tr.weights, fused_tr._indices, wh_scale=fused_tr._wh_scale,
            context=held_c, **fused_tr._static)
        gap = max_err(served_lp, trainer_lp)
        log(f"  to_flow() served through CompiledFlow vs the trainer's log_prob: {gap:.3e} "
            "(limit 1e-3)")
        if gap > 1e-3:
            raise AssertionError(f"the trained {model} served disagrees with the trainer")
        eager_gap = max_err(served_lp, state.flow.log_prob(held, held_c).detach())
        log(f"  fused-trained vs eager-trained log_prob after {TRAIN_STEPS} steps: "
            f"{eager_gap:.3e}")

        def timed_routes(n):
            steps, fused_tr, _ = routes(model_flow, n)
            return (steps, list(zip(batches(n, 4, seed=5), contexts(n, 4, 15, context_features))),
                    fused_tr)

        def repack(n, fused_tr, steps, args):
            ms = device_ms(torch, lambda: fused_tr._repack(fused_tr.weights), 20)
            log(f"  batch {n}: re-packing the weights for the forward GEMMs {ms:.4f} ms a step")

        time_steps(f"{model} train", timed_routes, "nsf", extra=repack, eager_at=eager_at)

    train_three_routes("NSF", flow, dict(B1=L))

    # -- phase 9: B9 against its plain version (full-width MAF and NSF-AR) ---------
    def bound(nops, nbytes):
        by_ops = nops / PEAK_FP32_FLOPS >= nbytes / PEAK_BYTES
        return (1e3 * max(nops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES),
                "operations" if by_ops else "bytes")

    seeded = lambda seed: dict(generator=torch.Generator().manual_seed(seed),  # noqa: E731
                               rng=np.random.default_rng(seed), device=dev)

    def tame(ar_flow, factor=0.1):
        """Scale the final MADE layer's weights of every affine AR layer. At
        the library's initialisation a full-width MAF's fixed point on N(0, 1)
        noise is ill-conditioned: a large early feature drives the later
        scales toward 1e-3, and the samples reach 1e13, where absolute errors
        mean nothing. A trained flow's inverse maps noise to data; smaller
        final weights give the random model that conditioning."""
        with torch.no_grad():
            for t in ar_flow.transform.transforms:
                net = getattr(getattr(t, "transform", t), "autoregressive_net", None)
                if net is not None:
                    net.final_layer.weight.mul_(factor)
        return ar_flow.eval()

    def hold_untamed_inverse(what, view, x, kw):
        """B9's fixed point on a flow as initialised, held by relative error:
        the degree kernel (the route) against both plain versions, the
        fixed-point kernel (forced) against its own."""
        ctx64 = {} if kw.get("context") is None else {"context": kw["context"].double()}
        y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
            x, view._weights, view._static, packed=view._packed, **kw)
        f_y, f_lad = maf_flow_kernel.maf_flow_kernel_cuda(
            x, view._weights, view._static, packed=view._packed, schedule="fixed_point", **kw)
        p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, view._weights, view._static, **kw)
        q_y, q_lad = maf_flow_kernel.maf_flow_kernel_plain(
            x, view._weights, view._static, schedule="degrees", masks=view._masks, **kw)
        d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(
            x.double(), {k: v.double() for k, v in view._weights.items()}, view._static,
            **{**kw, **ctx64})
        torch.cuda.synchronize()
        log(f"B9{what} on the {'conditional ' if ctx64 else ''}MAF as initialised, inverse of "
            f"N(0, 1) noise at N={x.shape[0]}: largest |sample| {float(d_y.abs().max()):.3e}")
        if not all(torch.isfinite(t).all() for t in (y, lad, f_y, f_lad)):
            raise AssertionError(f"B9{what} produced non-finite values on the MAF as initialised")
        for name, plain_y, plain_lad in (("fixed-point plain", p_y, p_lad),
                                         ("degree plain", q_y, q_lad)):
            hold_relative(torch, f"degree kernel, inverse out, against the {name}", y, plain_y,
                          d_y)
            hold_relative(torch, f"degree kernel, inverse lad, against the {name}", lad,
                          plain_lad, d_lad)
        hold_relative(torch, "fixed-point kernel, inverse out", f_y, p_y, d_y)
        hold_relative(torch, "fixed-point kernel, inverse lad", f_lad, p_lad, d_lad)

    def hold_fixed_point(tag, view, x, kw):
        """B9's fixed point at x within 5e-3 (see the module doc): the route's
        kernel, which must be the degree kernel, against both plain versions,
        and the fixed-point kernel (forced) against its own. Returns the
        degree kernel's (y, lad) and both kernels' largest |kernel - plain|."""
        ctx64 = {} if kw.get("context") is None else {"context": kw["context"].double()}
        w64 = {k: v.double() for k, v in view._weights.items()}
        before = maf_flow_kernel.degree_launch_count
        y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
            x, view._weights, view._static, packed=view._packed, **kw)
        if maf_flow_kernel.degree_launch_count != before + 1:
            raise AssertionError("B9's fixed point did not take the degree kernel")
        f_y, f_lad = maf_flow_kernel.maf_flow_kernel_cuda(
            x, view._weights, view._static, packed=view._packed, schedule="fixed_point", **kw)
        p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, view._weights, view._static, **kw)
        q_y, q_lad = maf_flow_kernel.maf_flow_kernel_plain(
            x, view._weights, view._static, schedule="degrees", masks=view._masks, **kw)
        d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(x.double(), w64, view._static,
                                                           **{**kw, **ctx64})
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (y, lad, f_y, f_lad)):
            raise AssertionError("B9 produced non-finite values")
        err = max(hold(f"{tag} out, degree kernel against the fixed-point plain", y, p_y, d_y,
                       5e-3),
                  hold(f"{tag} lad, degree kernel against the fixed-point plain", lad, p_lad,
                       d_lad, 5e-3),
                  hold(f"{tag} out, degree kernel against the degree plain", y, q_y, d_y, 5e-3),
                  hold(f"{tag} lad, degree kernel against the degree plain", lad, q_lad, d_lad,
                       5e-3))
        fp_err = max(hold(f"{tag} out, fixed-point kernel", f_y, p_y, d_y, 5e-3),
                     hold(f"{tag} lad, fixed-point kernel", f_lad, p_lad, d_lad, 5e-3))
        return y, lad, err, fp_err

    def time_fixed_point(view, x, kw, nops, io_bytes, fixed_point_ops):
        """B9's fixed point at x on both kernels in this run: the degree kernel
        (the route) at its own tile and at both tile sizes (each result
        equal to the route's within 1e-5), the
        fixed-point kernel, both plain versions; the bound, and each
        schedule's multiply count at the peak rate (the degree kernel's: its
        slabs once a sample, pad columns included)."""
        n = x.shape[0]
        w, st, dp = view._weights, view._static, view._packed["degrees"]
        run = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
            x, w, st, packed=view._packed, **kw)
        run_fp = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
            x, w, st, packed=view._packed, schedule="fixed_point", **kw)
        ms = device_ms(torch, run, 10, kernel="maf_degree_inverse")
        ms_source = device_ms.source
        fp_ms = device_ms(torch, run_fp, 5, kernel="maf_flow_kernel")
        plain_ms = device_ms(torch, lambda: maf_flow_kernel.maf_flow_kernel_plain(
            x, w, st, **kw), 3)
        degree_plain_ms = device_ms(torch, lambda: maf_flow_kernel.maf_flow_kernel_plain(
            x, w, st, schedule="degrees", masks=view._masks, **kw), 3)
        bound_ms, bound_by = bound(nops, io_bytes)
        slab_ops = 2 * n * dp["stream"].numel()
        groups = [b - a for a, b in zip(dp["offsets"][0].tolist(), dp["offsets"][0].tolist()[1:])]
        D_, H_ = x.shape[1], dp["bi"].shape[1]
        M_ = dp["bf"].shape[1] // D_
        C_ = 0 if kw.get("context") is None else kw["context"].shape[1]
        rows = maf_flow_kernel.degree_tile_rows(
            n, D_, H_, M_, view._num_blocks,
            torch.cuda.get_device_properties(dev).multi_processor_count, C_)
        ref_y, ref_lad = run()
        by_tile = {}
        for r in (16, 32):
            tiled = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
                x, w, st, packed=view._packed, rows=r, **kw)  # noqa: B023
            t_y, t_lad = tiled()
            gap = max(max_err(t_y, ref_y), max_err(t_lad, ref_lad))
            if gap > 1e-5:
                raise AssertionError(f"the degree kernel's result depends on the tile ({r} "
                                     f"rows: {gap:.3e})")
            by_tile[f"rows_{r}"] = device_ms(torch, tiled, 10, kernel="maf_degree_inverse")
        # below 16 x SMs samples degree_tile_rows takes 16-sample tiles: both
        # sizes at two such N, on the first samples of x
        small = {}
        for m in (512, 2048):
            xm = x[:m].contiguous()
            km = {**kw, "context": None if kw.get("context") is None
                  else kw["context"][:m].contiguous()}
            small[m] = {f"rows_{r}": device_ms(
                torch, lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: B023
                    xm, w, st, packed=view._packed, rows=r, **km), 10,  # noqa: B023
                kernel="maf_degree_inverse") for r in (16, 32)}
            small[m]["rule"] = maf_flow_kernel.degree_tile_rows(
                m, D_, H_, M_, view._num_blocks,
                torch.cuda.get_device_properties(dev).multi_processor_count, C_)
        log(f"  inverse time: degree kernel {ms:.4f} ms ({rows}-sample tiles), "
            f"fixed-point kernel {fp_ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, degree plain {degree_plain_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by}, {nops / 1e9:.2f} GFLOP needed, "
            f"{100 * bound_ms / ms:.1f}% of the degree kernel's time); the degree kernel "
            f"multiplies {slab_ops / 1e9:.2f} GFLOP ({bound(slab_ops, io_bytes)[0]:.4f} ms at "
            f"the peak rate), the fixed-point kernel {fixed_point_ops / 1e9:.1f} GFLOP")
        log(f"    degree groups of a layer {groups}, {dp['chunks'].shape[0]} ring chunks a "
            f"launch, by tile {by_tile}; at N = 512 and 2,048 (rows the rule takes) {small}")
        return {"inverse_ms": ms, "inverse_ms_source": ms_source,
                "inverse_fixed_point_ms": fp_ms, "inverse_plain_ms": plain_ms,
                "inverse_degree_plain_ms": degree_plain_ms, "inverse_bound_ms": bound_ms,
                "inverse_bound_by": bound_by,
                "inverse_schedule_ms": bound(slab_ops, io_bytes)[0],
                "inverse_fixed_point_schedule_ms": bound(fixed_point_ops, io_bytes)[0],
                "inverse_rows": rows, "inverse_ms_by_tile": by_tile,
                "inverse_ms_by_tile_at": small,
                "inverse_degree_groups": groups}

    raw_maf = MaskedAutoregressiveFlow(**MAF, **seeded(0)).eval()
    maf = tame(MaskedAutoregressiveFlow(**MAF, **seeded(0)))
    nsf_ar = NeuralSplineFlowAR(**NSF_AR, **seeded(0)).eval()
    iaf = tame(InverseAutoregressiveFlow(**MAF, use_random_permutations=True, **seeded(1)))
    DA, HA, LA = MAF["features"], MAF["hidden_features"], MAF["num_layers"]
    nba = MAF["num_blocks_per_layer"]
    LARGE_BATCH = 1 << 16
    default_rows = maf_flow_kernel.tile_rows(
        LARGE_BATCH, DA, HA, 2 * DA, torch.cuda.get_device_properties(dev).multi_processor_count)

    def masked_ops(n, ar_flow):
        """fp32 FLOP that one MADE pass of every layer needs on n samples:
        two for each weight the masks leave (about 55% of the matrices)."""
        masks = extract_maf(ar_flow, torch.float32, return_masks=True)[-1]
        return 2 * n * sum(int(m.sum()) for m in masks.values())

    def dense_ops(n, P):
        """fp32 FLOP of the same pass as the kernels run it: the folded
        weights' structural zeros are multiplied like any other entry."""
        return 2 * n * LA * (DA * HA + 2 * nba * HA * HA + HA * P)

    # B9's one-pass direction on both routes: the tensor-core kernel
    # (csrc/maf_flow_wgmma.cu, the route full-width chains take) and the
    # SIMT one (csrc/maf_flow_kernel.cu, forced), held and timed in one run
    B9_KERNEL = {"wgmma": "maf_flow_wgmma_kernel", "simt": "maf_flow_kernel"}

    def b9_one_pass(tag, view, x, kw, view32=None):
        """B9's one-pass direction at x (kw: its arguments) by the route,
        which must be wgmma, and on the SIMT kernel forced, each against the
        plain version: fp32 by ``hold`` (1e-3, or twice the plain version's
        distance from float64) and by ``hold_relative`` within
        ``ONE_PASS_LIMITS``, which tells 3xTF32 from a lower precision that
        the absolute band would pass; bf16 weights by ``hold_bf16`` against
        the bf16 plain version in phase 31's bands (``view32``: the fp32
        view, for the fp32 plain version). Returns the route's (y, lad) and
        each route's largest error."""
        w, st = view._weights, view._static
        bf16 = w["wi"].dtype == torch.bfloat16
        ctx = kw.get("context")
        p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(x, w, st, **kw)
        if bf16:
            q_y, q_lad = maf_flow_kernel.maf_flow_kernel_plain(x, view32._weights, st, **kw)
        else:
            d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(
                x.double(), {k: v.double() for k, v in w.items()}, st,
                **{**kw, "context": None if ctx is None else ctx.double()})
        out, errs = None, {}
        for gr in ("wgmma", "simt"):
            before = dict(maf_flow_kernel.route_launch_count)
            y, lad = maf_flow_kernel.maf_flow_kernel_cuda(
                x, w, st, packed=view._packed, gemm=None if gr == "wgmma" else gr, **kw)
            torch.cuda.synchronize()
            key = gr + ("_bf16" if bf16 else "")
            if maf_flow_kernel.route_launch_count[key] != before[key] + 1:
                raise AssertionError(f"B9 {tag}: the call did not take the {gr} route")
            if not (torch.isfinite(y).all() and torch.isfinite(lad).all()):
                raise AssertionError(f"B9 ({gr}) produced non-finite values")
            if bf16:
                errs[gr] = max(hold_bf16(f"{gr} {tag} out", y, p_y, q_y, BF16_OUT),
                               hold_bf16(f"{gr} {tag} lad", lad, p_lad, q_lad, BF16_LAD))
            else:
                errs[gr] = max(hold(f"{gr} {tag} out", y, p_y, d_y, 1e-3),
                               hold(f"{gr} {tag} lad", lad, p_lad, d_lad, 1e-3))
                for what, got, p32, p64 in (("out", y, p_y, d_y), ("lad", lad, p_lad, d_lad)):
                    hold_relative(torch, f"{gr} {tag} {what}", got, p32, p64,
                                  limits=ONE_PASS_LIMITS)
            out = out or (y, lad)
        return out, errs

    def b9_route_times(view, x, kw, iters=10):
        """Device ms of B9's one-pass direction at x on each route."""
        times = {}
        for gr in ("wgmma", "simt"):
            run = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
                x, view._weights, view._static, packed=view._packed, gemm=gr, **kw)  # noqa: B023
            times[gr] = (device_ms(torch, run, iters, kernel=B9_KERNEL[gr]), device_ms.source)
        return times

    def b9_route_bound(nops, dense, io_bytes, bf16=False):
        """B9's least time on the wgmma route: the operations the masks
        leave (``nops``) on the units it runs them on (bf16: the bf16 tensor
        cores; fp32: 3xTF32, three TF32 products a product), or the bytes;
        the dense count the kernel multiplies at the same rate beside it."""
        rate, mult = (PEAK_BF16_FLOPS, 1) if bf16 else (PEAK_TF32_FLOPS, 3)
        ops_ms, io_ms = 1e3 * mult * nops / rate, 1e3 * io_bytes / PEAK_BYTES
        return dict(bound_ms=max(ops_ms, io_ms),
                    bound_by="operations" if ops_ms >= io_ms else "bytes",
                    bound_basis=("bf16 tensor cores, 989 TFLOP/s" if bf16 else
                                 "3xTF32: three TF32 products each, 495 TFLOP/s"),
                    dense_ms=max(1e3 * mult * dense / rate, io_ms))

    # the MAF as initialised, the configuration a user builds: its sampling
    # direction on N(0, 1) noise, held by relative error
    view = fuse_maf(raw_maf)
    x = torch.randn(SERVE_BATCH, DA, generator=gen).to(dev)
    kw = dict(inverse=True, num_blocks=view._num_blocks, transformer=view._transformer,
              spline_kw=view._spline_kw)
    hold_untamed_inverse("", view, x, kw)
    # and its one-pass direction on both routes, on the same inputs, with an
    # IAF's sampling direction as initialised: the fp32 band and the relative
    # quantiles
    log(f"B9's one pass on the MAF and the IAF as initialised at N={x.shape[0]}:")
    b9_untamed = {}
    for model, ar_flow, inverse in (
            ("MAF", raw_maf, False),
            ("IAF", InverseAutoregressiveFlow(**MAF, use_random_permutations=True,
                                              **seeded(1)).eval(), True)):
        v = fuse_maf(ar_flow)
        b9_untamed[model] = b9_one_pass(
            f"{model} as initialised, {'inverse' if inverse else 'forward'}", v, x,
            dict(kw, inverse=inverse))[1]

    b9, b9_wgmma = {}, {}
    for model, ar_flow in (("MAF", maf), ("NSF-AR", nsf_ar), ("IAF", iaf)):
        view = fuse_maf(ar_flow)
        w32 = view._weights
        skw = dict(num_blocks=view._num_blocks, transformer=view._transformer,
                   spline_kw=view._spline_kw)
        P = w32["wf"].shape[0] // LA
        ar_bytes = 4 * sum(v.numel() for v in w32.values())
        need = masked_ops(1, ar_flow)
        for n in (SERVE_BATCH, RAGGED):
            # the IAF's ragged N from a generator of its own: the shared one
            # draws for every later phase what it drew before that size came
            draw = torch.Generator().manual_seed(n) if model == "IAF" and n == RAGGED else gen
            x = torch.randn(n, DA, generator=draw).to(dev)
            log(f"B9 on {model} at N={n}:")
            errs = {}
            for inverse in (False, True):
                kw = dict(inverse=inverse, **skw)
                tag = "inverse" if inverse else "forward"
                if inverse != (model == "IAF"):
                    y, lad, errs[tag], errs[tag + "_fixed_point"] = hold_fixed_point(
                        tag, view, x, kw)
                else:
                    (y, lad), one = b9_one_pass(tag, view, x, kw)
                    errs[tag], errs[tag + "_simt"] = one["wgmma"], one["simt"]
                back, lad_back = maf_flow_kernel.maf_flow_kernel_cuda(
                    y, w32, view._static, packed=view._packed, **{**kw, "inverse": not inverse})
                trip = max(max_err(back, x), max_err(lad_back, -lad))
                log(f"  {tag} then back: {trip:.3e} from the input (limit 5e-3)")
                if trip > 5e-3:
                    raise AssertionError(f"B9 {model}: the round trip does not close")
            if n != SERVE_BATCH:
                continue
            # the one-pass direction on both routes: time, bound on each
            # route's units, the dense count the tensor cores multiply
            kw = dict(inverse=model == "IAF", **skw)
            nops = n * need
            run_ops = dense_ops(n, P)
            io_bytes = ar_bytes + 4 * n * (2 * DA + 1)
            times = b9_route_times(view, x, kw)
            run_plain = lambda: maf_flow_kernel.maf_flow_kernel_plain(  # noqa: E731
                x, w32, view._static, **kw)
            plain_ms = device_ms(torch, run_plain, 3)
            bound_ms, bound_by = bound(nops, io_bytes)
            wb = b9_route_bound(nops, run_ops, io_bytes)
            tag = "inverse" if model == "IAF" else "forward"
            log(f"  {tag} time: wgmma kernel {times['wgmma'][0]:.4f} ms, simt kernel "
                f"{times['simt'][0]:.4f} ms  plain {plain_ms:.4f} ms; bound on the wgmma route "
                f"{wb['bound_ms']:.4f} ms ({wb['bound_by']}, {wb['bound_basis']}; the dense "
                f"{run_ops / 1e9:.1f} GFLOP it multiplies {wb['dense_ms']:.4f} ms), on the CUDA "
                f"cores {bound_ms:.4f} ms ({nops / 1e9:.2f} GFLOP needed)")
            b9_wgmma[model] = dict(err=errs[tag], ms=times["wgmma"][0],
                                   ms_source=times["wgmma"][1], simt_ms=times["simt"][0],
                                   plain_ms=plain_ms, **wb,
                                   untamed_err=b9_untamed.get(model, {}).get("wgmma"))
            if model == "IAF":
                continue
            stats = dict(err=errs["forward_simt"], inverse_err=errs["inverse"],
                         inverse_fixed_point_err=errs["inverse_fixed_point"])
            ms, ms_source = times["simt"]
            log(f"  a call, events: simt kernel "
                f"{call_ms(torch, lambda: maf_flow_kernel.maf_flow_kernel_cuda(x, w32, view._static, packed=view._packed, gemm='simt', **kw), 10):.4f} ms  "  # noqa: E501
                f"plain {call_ms(torch, run_plain, 3):.4f} ms")
            stats.update(ms=ms, ms_source=ms_source, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, schedule_ms=bound(run_ops, io_bytes)[0])
            # the inverse: both kernels of the fixed point
            kw = dict(inverse=True, **skw)
            stats.update(time_fixed_point(view, x, kw, nops, io_bytes,
                                          dense_ops(n, P) * (DA + 1)))
            # the fixed-point kernel's tile-size diagnostic: 64-sample tiles
            # halve its weight traffic but fill half the SMs here
            ref_y, ref_lad = maf_flow_kernel.maf_flow_kernel_cuda(
                x, w32, view._static, packed=view._packed, schedule="fixed_point", **kw)
            for rows in (32, 64):
                tiled = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
                    x, w32, view._static, packed=view._packed, rows=rows,  # noqa: B023
                    schedule="fixed_point", **kw)
                t = device_ms(torch, tiled, 5, kernel="maf_flow_kernel")
                t_y, t_lad = tiled()
                gap = max(max_err(t_y, ref_y), max_err(t_lad, ref_lad))
                log(f"    fixed-point kernel with {rows}-sample tiles: {t:.4f} ms, {gap:.3e} "
                    "from the default tile's result (limit 1e-5)")
                if gap > 1e-5:
                    raise AssertionError(f"B9 {model}: the result depends on the tile")
            xt = x[:TRAIN_BATCH].contiguous()
            fkw = dict(inverse=False, **skw)
            b9_one_pass(f"forward at N={TRAIN_BATCH}", view, xt, fkw)
            t512 = b9_route_times(view, xt, fkw)
            ms512 = t512["simt"][0]
            b9_wgmma[model].update(ms_at_512=t512["wgmma"][0], simt_ms_at_512=ms512,
                                   **{f"{k}_at_512": v for k, v in b9_route_bound(
                                       TRAIN_BATCH * need, dense_ops(TRAIN_BATCH, P),
                                       ar_bytes + 4 * TRAIN_BATCH * (2 * DA + 1)).items()
                                      if k.endswith("_ms")})
            log(f"  forward at N={TRAIN_BATCH}: wgmma kernel {t512['wgmma'][0]:.4f} ms, simt "
                f"kernel {ms512:.4f} ms; bound {bound(TRAIN_BATCH * need, ar_bytes)[0]:.4f} ms "
                f"on the CUDA cores, {b9_wgmma[model]['bound_ms_at_512']:.4f} on the wgmma "
                "route")
            # at a large batch: the forward at the wrapper's tile (64 samples,
            # once that gives every SM a tile) against 32; the inverse on the
            # degree kernel at 16- and 32-sample tiles against the fixed-point
            # kernel at its own choice
            xl = torch.randn(LARGE_BATCH, DA, generator=gen).to(dev)
            b9_one_pass(f"forward at N={LARGE_BATCH}", view, xl, fkw)
            tl = b9_route_times(view, xl, fkw, iters=3)
            b9_wgmma[model].update(ms_at_65536=tl["wgmma"][0], simt_ms_at_65536=tl["simt"][0])
            log(f"  forward at N={LARGE_BATCH}: wgmma kernel {tl['wgmma'][0]:.4f} ms, simt "
                f"kernel {tl['simt'][0]:.4f} ms")
            large = {}
            for tag, name, inverse, variants in (
                    ("forward", "maf_flow_kernel", False, ((32, None), (64, None))),
                    ("inverse", "maf_degree_inverse", True, ((16, None), (32, None))),
                    ("inverse", "maf_flow_kernel", True, ((None, "fixed_point"),))):
                for rows, schedule in variants:
                    tiled = lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: E731
                        xl, w32, view._static, packed=view._packed, rows=rows,  # noqa: B023
                        schedule=schedule, inverse=inverse, **skw)  # noqa: B023
                    key = (schedule or f"rows_{rows or default_rows}"
                           if inverse else f"rows_{rows or default_rows}")
                    large.setdefault(tag, {})[key] = device_ms(torch, tiled, 3, kernel=name)
            log(f"  at N={LARGE_BATCH}, forward by tile {large['forward']}, inverse (the degree "
                f"kernel by tile, the fixed-point kernel) {large['inverse']}; bound "
                f"{bound(LARGE_BATCH * need, ar_bytes)[0]:.4f} ms")
            for tag, times in large.items():
                stats[f"{tag}_ms_at_{LARGE_BATCH}"] = times
            b9[model] = stats

    # -- phase 10: serving the autoregressive flows through CompiledFlow ------------
    # the unfused MAF launches no kernel of the port (its transformer is plain
    # tensor code); the unfused NSF-AR runs B1 once a MADE pass: LA a log_prob,
    # LA x DA a sampling request
    # a fused log_prob request is one B9 launch, on the tensor cores
    # (B9_wgmma), a fused sampling request one of the degree kernel; the
    # IAF's the other way round (b9_route_counts), its inputs from a
    # generator of their own
    ar_sample = dict(B9=2)
    serve("MAF", maf, DA, "B9", {}, {}, fused_sample=ar_sample)
    serve("NSF-AR", nsf_ar, DA, "B9", dict(B1=LA), dict(B1=LA * DA), fused_sample=ar_sample)
    serve("IAF", iaf, DA, "B9", {}, {}, fused_sample=ar_sample,
          draw=torch.Generator().manual_seed(10))

    # -- phase 11: B10 against its plain version (full-width MAF and NSF-AR) --------
    def b10_occupancy(d):
        """The clusters of each size of B10's cluster kernel the card holds
        at once, at the shared memory of chain dims ``d``."""
        return {c: maf_train.active_clusters(dev, d["C"], c, maf_train.shared_memory_bytes(
            32, d["D"], d["L"], d["H"], d["P"], d["C"], c)) for c in maf_train.CLUSTER_SIZES}

    def b10_every_cluster(chosen, call, check):
        """B10 at every cluster size its 32-sample tiles can take other than
        ``chosen`` (one block a tile, csrc/maf_train.cu, and clusters of 2, 4
        and 8, csrc/maf_train_cluster.cu): ``call(c)`` launches it, and
        ``check(c, gx, grads, indent)`` holds the result and returns the
        errors."""
        errs = []
        for c in (1, *maf_train.CLUSTER_SIZES):
            if c == chosen:
                continue
            log(f"  cluster size {c}:")
            gx, grads = call(c)
            torch.cuda.synchronize()
            errs += check(c, gx, grads, "  ")
        return errs

    def b10_cluster_times(call):
        """B10's device ms at each cluster size, 32-sample tiles: {CS: ms}."""
        return {c: device_ms(torch, lambda: call(c), 10, kernel="maf_train_bwd")  # noqa: B023
                for c in (1, *maf_train.CLUSTER_SIZES)}

    b10_tie = {}   # what B10_TIE showed

    b10 = {}
    mstacks = maf_train.WEIGHT_KEYS
    for model, ar_flow in (("MAF", maf), ("NSF-AR", nsf_ar)):
        mtr = fused_trainer(ar_flow, TRAIN_BATCH)
        if not isinstance(mtr, maf_train.FusedMAFTrainer):
            raise AssertionError(f"fused_trainer gave {type(mtr).__name__} for {model}")
        f32 = {k: v.detach().contiguous() for k, v in mtr._fold(mtr.weights).items()}
        f64 = {k: v.double() for k, v in f32.items()}
        mkw = dict(wh_scale=mtr._wh_scale, **mtr._static)
        P = mtr._dims["P"]
        ar_bytes = 4 * sum(v.numel() for v in f32.values())
        need = masked_ops(1, ar_flow)
        mpacked = maf_flow_kernel.pack_weights(f32, mtr._layers, nba)
        active = b10_occupancy(mtr._dims)
        # the inputs at 2,048 come from a generator of their own, so that the
        # shared one draws what it drew before that size was added
        for n in (TRAIN_BATCH, 2048, SERVE_BATCH):
            draw = torch.Generator().manual_seed(n) if n == 2048 else gen
            x = (1.5 * torch.randn(n, DA, generator=draw)).to(dev)
            gy = (torch.randn(n, DA, generator=draw) / n).to(dev)
            glad = (torch.randn(n, generator=draw) / n).to(dev)
            rows, chosen, grid = maf_train.launch_layout(n, mtr._dims, dev)
            log(f"B10 on {model} at N={n}: {-(-n // rows)} tiles of {rows} samples, cluster "
                f"size {chosen} (grid {grid}); active clusters by size {active}")
            gx, grads = maf_train.maf_train_bwd_cuda(x, gy, glad, f32, mtr._layers, **mkw)
            p_gx, p_grads = maf_train.maf_train_bwd_plain(x, gy, glad, f32, mtr._layers, **mkw)
            d_gx, d_grads = maf_train.maf_train_bwd_plain(
                x.double(), gy.double(), glad.double(), f64, mtr._layers, **mkw)
            torch.cuda.synchronize()
            if not all(torch.isfinite(t).all() for t in (gx, *grads.values())):
                raise AssertionError("B10 produced non-finite values")
            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")

            def check(c, gx, grads, ind=""):  # noqa: B023 (used in its iteration)
                if (model, n, c) == (B10_TIE["model"], B10_TIE["n"], B10_TIE["cluster"]):
                    gx_err, b10_tie[(model, n, c)] = hold_b10_tie(
                        torch, gx, p_gx, d_gx, lambda *a, **kw: maf_train.maf_train_bwd_plain(
                            *a, f64, mtr._layers, **kw, **mkw), x, gy, glad, ind)  # noqa: B023
                else:
                    gx_err = hold(f"{ind}gx * N", gx * n, p_gx * n, d_gx * n, 5e-3)
                return [gx_err] + [hold(f"{ind}g{k}", grads[k], p_grads[k], d_grads[k], 2e-4)
                                   for k in mstacks]

            errs = check(chosen, gx, grads)
            if n != SERVE_BATCH:
                errs += b10_every_cluster(chosen, lambda c: maf_train.maf_train_bwd_cuda(
                    x, gy, glad, f32, mtr._layers, rows=32, cluster=c, **mkw),  # noqa: B023
                    check)
            run = lambda: maf_train.maf_train_bwd_cuda(  # noqa: E731
                x, gy, glad, f32, mtr._layers, packed=mpacked, grads=grads, **mkw)
            run_plain = lambda: maf_train.maf_train_bwd_plain(  # noqa: E731
                x, gy, glad, f32, mtr._layers, **mkw)
            ms = device_ms(torch, run, 10, kernel="maf_train_bwd")
            ms_source = device_ms.source
            by_cluster = b10_cluster_times(lambda c: maf_train.maf_train_bwd_cuda(  # noqa: B023
                x, gy, glad, f32, mtr._layers, packed=mpacked, grads=grads, rows=32,
                cluster=c, **mkw))
            plain_ms = device_ms(torch, run_plain, 3)
            # recompute, input cotangents and weight gradients, each over the
            # weights the masks leave; the kernel runs the three dense
            nops = 3 * n * need
            run_ops = 3 * dense_ops(n, P)
            io_bytes = 2 * ar_bytes + 4 * n * (3 * DA + 1)
            bound_ms, bound_by = bound(nops, io_bytes)
            log(f"  time: kernel {ms:.4f} ms (cluster size {chosen})  plain {plain_ms:.4f} ms  "
                f"bound {bound_ms:.4f} ms ({bound_by}, {nops / 1e9:.2f} GFLOP needed); the "
                f"kernel's schedule multiplies {run_ops / 1e9:.1f} GFLOP "
                f"({bound(run_ops, io_bytes)[0]:.4f} ms at the peak rate), "
                f"{run_ops / ms / 1e9:.1f} TFLOP/s; by cluster size "
                f"{json.dumps({c: round(t, 4) for c, t in by_cluster.items()})}")
            b10[(model, n)] = dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   schedule_ms=bound(run_ops, io_bytes)[0], cluster_size=chosen,
                                   ms_by_cluster_size=by_cluster, active_clusters=active)

    # -- phase 12: training the MAF on the card ----------------------------------------
    b10_phase_launches = {}   # B10's launches a fused step by cluster size, by phase
    b9_trainer_weights = {}   # B9's wgmma kernel forced on a trainer's weights, by model
    b10_step_clusters = {}    # B10's cluster size and the fused step's ms by batch

    def b10_step_layout(phase, trainer, n):
        """Check that the fused step just taken launched B10 once, at the
        cluster size the wrapper chooses for batch n, and keep its
        launches by cluster size for the kernels line."""
        counts = b10_layouts()
        _, chosen, grid = maf_train.launch_layout(n, trainer._dims, dev)
        log(f"  its B10: cluster size {chosen}, grid {grid}; launches by cluster size {counts}")
        if counts != {chosen: 1}:
            raise AssertionError(f"{phase}: B10 ran {counts}, expected once at cluster size "
                                 f"{chosen}")
        b10_phase_launches[phase] = counts

    def b10_step_cluster(n, trainer):
        rows, chosen, grid = maf_train.launch_layout(n, trainer._dims, dev)
        log(f"  batch {n}: the fused step's B10 runs {-(-n // rows)} tiles of {rows} samples at "
            f"cluster size {chosen} (grid {grid})")
        return {"cluster_size": chosen}

    mix_a = torch.randn(DA, DA, generator=gen).to(dev) / DA ** 0.5
    mix_c = torch.randn(MOG_CONTEXT, DA, generator=gen).to(dev) / MOG_CONTEXT ** 0.5

    def ar_batches(n, count, seed, context_features=None):
        """Seeded synthetic (batch, context) pairs: correlated Gaussian
        features in 10 dimensions, shifted by a linear function of an N(0, 1)
        context where the model has one (None where it has not)."""
        g = torch.Generator(device=dev).manual_seed(seed)
        out = []
        for _ in range(count):
            x = 1.5 * torch.randn(n, DA, generator=g, device=dev) @ mix_a + 0.5
            if context_features is None:
                out.append((x, None))
                continue
            c = torch.randn(n, context_features, generator=g, device=dev)
            out.append((x + c @ mix_c, c))
        return out

    def train_ar(model, model_flow, context_features=None):
        """Train ``model_flow`` (an affine autoregressive flow) 20 Adam steps
        fused (one B9 and one B10 a step) and eager; check the launches, the
        first three losses, a falling loss (the last under the first, and
        the mean of the last five under that of the first five), that the
        masked entries stay bit-equal while the others and the context
        stacks move, and the fused-trained flow served through CompiledFlow
        against the trainer; then time a step of each route."""
        def routes(n):
            fused_tr = fused_trainer(copy.deepcopy(model_flow), n)
            state = create_train_state(copy.deepcopy(model_flow).train(), adam)
            eager_step = make_train_step()
            steps = {"fused": fused_tr.make_train_step(fused_tr.init_opt(adam)),
                     "eager": lambda batch, c=None: eager_step(state, batch, c)[1]["loss"]}
            return steps, fused_tr, state

        steps, fused_tr, state = routes(TRAIN_BATCH)
        start = {k: v.detach().clone() for k, v in fused_tr.weights.items()}
        data = ar_batches(TRAIN_BATCH, TRAIN_STEPS, 6, context_features)
        losses = {}
        # the fused step's B9 is the SIMT kernel (the trainer re-packs its
        # weights every step)
        for name, expected in (("fused", dict(B9=1, B9_simt=1, B10=1)), ("eager", {})):
            reset_counts()
            first = steps[name](*data[0])
            torch.cuda.synchronize()
            counts = read_counts()
            log(f"training {model} ({name}): launches a step {counts}")
            expect_counts(f"one {name} {model} step", counts, **expected)
            if name == "fused":
                book = launches if context_features is None else context_launches
                book["B10"], book["B9_simt"] = counts["B10"], counts["B9_simt"]
                b10_step_layout(f"{model} train", fused_tr, TRAIN_BATCH)
            rest = [steps[name](*batch) for batch in data[1:]]
            curve = losses[name] = [float(v) for v in [first, *rest]]
            log(f"  {TRAIN_STEPS} Adam steps (lr 3e-4, batch {TRAIN_BATCH}): loss "
                f"{curve[0]:.4f} -> {curve[-1]:.4f}")
            if (not all(np.isfinite(curve)) or not curve[-1] < curve[0]
                    or not np.mean(curve[-5:]) < np.mean(curve[:5])):
                raise AssertionError(f"{model} {name}: the loss is not finite and falling: "
                                     f"{curve}")
        gap = max(abs(a - b) for a, b in zip(losses["fused"][:3], losses["eager"][:3]))
        log(f"  first three losses, fused vs eager: {gap:.3e} apart (limit 2e-3)")
        if gap > 2e-3:
            raise AssertionError(f"the fused and eager {model} routes disagree at the start")
        for k in maf_train.MASKED_KEYS:
            dead = fused_tr._masks[k] == 0
            moved = not torch.equal(fused_tr.weights[k].detach()[dead], start[k][dead])
            live = not torch.equal(fused_tr.weights[k].detach()[~dead], start[k][~dead])
            log(f"  {k}: {int(dead.sum())} masked entries bit-equal after {TRAIN_STEPS} "
                f"steps: {not moved}; the others moved: {live}")
            if moved or not live:
                raise AssertionError(f"{model} {k}: masked entries moved, or nothing trained")
        for k in maf_flow_kernel.CONTEXT_KEYS if context_features else ():
            if torch.equal(fused_tr.weights[k].detach(), start[k]):
                raise AssertionError(f"{model} {k}: the context weights did not train")
        held, held_c = ar_batches(TRAIN_BATCH, 1, 7, context_features)[0]
        served_lp = CompiledFlow(fused_tr.to_flow().eval(), batch_size=TRAIN_BATCH, features=DA,
                                 context_features=context_features).log_prob(held, held_c)
        with torch.no_grad():
            y, lad = fused_tr._apply(fused_tr.weights, held, held_c)
            trainer_lp = -0.5 * (y * y).sum(dim=1) - 0.5 * DA * np.log(2 * np.pi) + lad
        gap = max_err(served_lp, trainer_lp)
        log(f"  to_flow() served through CompiledFlow vs the trainer's log_prob: {gap:.3e} "
            "(limit 1e-3)")
        if gap > 1e-3:
            raise AssertionError(f"the trained {model} served disagrees with the trainer")
        log(f"  fused-trained vs eager-trained log_prob after {TRAIN_STEPS} steps: "
            f"{max_err(served_lp, state.flow.log_prob(held, held_c).detach()):.3e}")
        # B9 on the tensor cores, forced, on the trainer's folded weights
        # (wh_scale unfolded) at the training batch, beside the SIMT kernel
        # the step runs: nothing routes it there, the trainer re-packs its
        # weights every step
        folded = {k: v.detach() for k, v in fused_tr._fold(fused_tr.weights).items()}
        tkw = dict(inverse=False, wh_scale=fused_tr._wh_scale, context=held_c,
                   **fused_tr._static)
        nb_ = fused_tr._static["num_blocks"]
        tpacked = {**maf_flow_kernel.pack_weights(folded, fused_tr._layers, nb_),
                   "wgmma": maf_flow_kernel.pack_weights_wgmma(folded, fused_tr._layers, nb_)}

        def run_route(gr):
            return maf_flow_kernel.maf_flow_kernel_cuda(held, folded, fused_tr._layers,
                                                        packed=tpacked, gemm=gr, **tkw)

        y_w, lad_w = run_route("wgmma")
        p_y, p_lad = maf_flow_kernel.maf_flow_kernel_plain(held, folded, fused_tr._layers, **tkw)
        d_y, d_lad = maf_flow_kernel.maf_flow_kernel_plain(
            held.double(), {k: v.double() for k, v in folded.items()}, fused_tr._layers,
            **{**tkw, "context": None if held_c is None else held_c.double()})
        torch.cuda.synchronize()
        err_w = max(hold("B9 (wgmma, forced) on the trainer's weights, out", y_w, p_y, d_y, 1e-3),
                    hold("B9 (wgmma, forced) on the trainer's weights, lad", lad_w, p_lad, d_lad,
                         1e-3))
        t_w, t_s = (device_ms(torch, lambda: run_route(gr), 10, kernel=B9_KERNEL[gr])  # noqa: B023
                    for gr in ("wgmma", "simt"))
        log(f"  B9 on the trainer's weights at N={TRAIN_BATCH}: wgmma (forced) {t_w:.4f} ms, "
            f"the step's simt kernel {t_s:.4f} ms")
        b9_trainer_weights[model] = dict(err=err_w, wgmma_ms=t_w, simt_ms=t_s)

        def timed_routes(n):
            steps, fused_tr, _ = routes(n)
            return steps, ar_batches(n, 4, 8, context_features), fused_tr

        def fold(n, fused_tr, steps, args):
            ms = device_ms(torch, lambda: fused_tr._repack(fused_tr._fold(fused_tr.weights)), 20)
            log(f"  batch {n}: folding the masks and re-packing the weights {ms:.4f} ms a step")
            b10_step_clusters[f"{model} train"][n] = b10_step_cluster(n, fused_tr)
            if n == TRAIN_BATCH:
                log(f"{model}'s fused step at batch {n}:")
                host_ops(lambda: steps["fused"](*args[0]))

        b10_step_clusters[f"{model} train"] = {}
        walls = time_steps(f"{model} train", timed_routes, "maf", extra=fold)
        for n, layout in b10_step_clusters[f"{model} train"].items():
            layout["fused_step_ms"] = walls[("fused", n)]

    train_ar("MAF", maf)

    # -- phase 13: B11 against its plain version (full-width MADEMoG) ------------------
    mog = MixtureOfGaussiansMADE(**MOG, **seeded(0)).eval()
    mog_ctx = MADEMoG(**MOG, context_features=MOG_CONTEXT, custom_initialization=True,
                      **seeded(1)).eval()
    DM = MOG["features"]
    mog_models = (("MoG-MADE", mog, None), ("MADEMoG, context", mog_ctx, MOG_CONTEXT))

    def mog_ops(model, n):
        """fp32 FLOP of one MADE pass on n samples: the weights the masks
        leave and every context weight (``need``), and the dense count the
        kernels run (``dense``), two for each."""
        weights, _, cf, masks = mademog_fused._extract(model, torch.float32, return_masks=True)
        ctx_weights = sum(weights[k].numel() for k in ("wci", "wcb") if cf)
        dense = sum(weights[k].numel() for k in ("wi", "wb", "wf")) + ctx_weights
        need = sum(int(m.sum()) for m in masks.values()) + ctx_weights
        return 2 * n * need, 2 * n * dense

    # B11 on both routes: the tensor-core kernel (csrc/mademog_wgmma.cu, the
    # route full-width models take) and the SIMT one (csrc/mademog_fused.cu,
    # forced), held and timed in one run
    B11_KERNEL = {"wgmma": "mademog_wgmma_kernel", "simt": "mademog_log_prob_kernel"}

    def b11_routes(tag, view, x, c, view32=None):
        """B11 at x (context c) by the route, which must be wgmma, and on the
        SIMT kernel forced, each against the plain version: fp32 by ``hold``
        (1e-3, or twice the plain version's distance from float64) and by
        ``hold_relative`` within ``ONE_PASS_LIMITS``, which tells 3xTF32
        from a lower precision that the band would pass; bf16 weights by
        ``hold_bf16`` against the bf16 plain version in phase 31's bands
        (``view32``: the fp32 view). Returns each route's largest error."""
        w, st = view._weights, view._static
        bf16 = w["wi"].dtype == torch.bfloat16
        p_lp = mademog_fused.mademog_log_prob_plain(x, w, st, c)
        if bf16:
            q_lp = mademog_fused.mademog_log_prob_plain(x, view32._weights, st, c)
        else:
            d_lp = mademog_fused.mademog_log_prob_plain(
                x.double(), {k: v.double() for k, v in w.items()}, st,
                None if c is None else c.double())
        errs = {}
        for gr in ("wgmma", "simt"):
            before = dict(mademog_fused.route_launch_count)
            lp = mademog_fused.mademog_log_prob_cuda(x, w, st, c, packed=view._packed,
                                                     gemm=None if gr == "wgmma" else gr)
            torch.cuda.synchronize()
            key = gr + ("_bf16" if bf16 else "")
            if mademog_fused.route_launch_count[key] != before[key] + 1:
                raise AssertionError(f"B11 {tag}: the call did not take the {gr} route")
            if tuple(lp.shape) != (x.shape[0],) or not torch.isfinite(lp).all():
                raise AssertionError(f"B11 ({gr}) produced non-finite values")
            if bf16:
                errs[gr] = hold_bf16(f"{gr} {tag} lp", lp, p_lp, q_lp, BF16_LAD)
            else:
                errs[gr] = hold(f"{gr} {tag} lp", lp, p_lp, d_lp, 1e-3)
                hold_relative(torch, f"{gr} {tag} lp", lp, p_lp, d_lp, limits=ONE_PASS_LIMITS)
        return errs

    def b11_route_times(view, x, c, iters=10):
        """Device ms of B11 at x on each route."""
        return {gr: (device_ms(torch, lambda: mademog_fused.mademog_log_prob_cuda(  # noqa: B023
            x, view._weights, view._static, c, packed=view._packed, gemm=gr),  # noqa: B023
            iters, kernel=B11_KERNEL[gr]), device_ms.source) for gr in ("wgmma", "simt")}

    b11, b11_wgmma = {}, {}
    for model, dist, cf in mog_models:
        view = mademog_fused.fuse_mademog(dist)
        w32 = view._weights
        mog_bytes = 4 * sum(v.numel() for v in w32.values())
        for n in (SERVE_BATCH, LARGE_BATCH, RAGGED):
            x = (1.5 * torch.randn(n, DM, generator=gen)).to(dev)
            c = None if cf is None else torch.randn(n, cf, generator=gen).to(dev)
            log(f"B11 on the {model} at N={n}, routes wgmma and simt:")
            errs = b11_routes(f"N={n}", view, x, c)
            if n == RAGGED:
                b11_wgmma[(model, n)] = dict(err=errs["wgmma"], simt_err=errs["simt"])
                continue
            iters = 10 if n == SERVE_BATCH else 3
            times = b11_route_times(view, x, c, iters)
            run_plain = lambda: mademog_fused.mademog_log_prob_plain(  # noqa: E731
                x, w32, view._static, c)  # noqa: B023
            plain_ms = device_ms(torch, run_plain, 5 if n == SERVE_BATCH else 2)
            need, dense = mog_ops(dist, n)
            io_bytes = mog_bytes + 4 * n * (DM + (cf or 0) + 1)
            bound_ms, bound_by = bound(need, io_bytes)
            wb = b9_route_bound(need, dense, io_bytes)
            (ms, ms_source), (simt_ms, simt_source) = times["wgmma"], times["simt"]
            log(f"  time: wgmma kernel {ms:.4f} ms, simt kernel {simt_ms:.4f} ms, plain "
                f"{plain_ms:.4f} ms; bound on the wgmma route {wb['bound_ms']:.4f} ms "
                f"({wb['bound_by']}, {wb['bound_basis']}; the dense {dense / 1e9:.2f} GFLOP it "
                f"multiplies {wb['dense_ms']:.4f} ms), on the CUDA cores {bound_ms:.4f} ms "
                f"({bound_by}, {need / 1e9:.2f} GFLOP needed; the SIMT kernel's schedule "
                f"{bound(dense, io_bytes)[0]:.4f} ms, {dense / simt_ms / 1e9:.1f} TFLOP/s)")
            b11[(model, n)] = dict(err=errs["simt"], ms=simt_ms, ms_source=simt_source,
                                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   schedule_ms=bound(dense, io_bytes)[0])
            b11_wgmma[(model, n)] = dict(err=errs["wgmma"], ms=ms, ms_source=ms_source,
                                         simt_ms=simt_ms, plain_ms=plain_ms, **wb)
            if n == SERVE_BATCH:
                # a tile's latency: the first 512 samples of the same inputs
                xs, cs = x[:TRAIN_BATCH].contiguous(), None if c is None else c[
                    :TRAIN_BATCH].contiguous()
                b11_routes(f"N={TRAIN_BATCH}", view, xs, cs)
                t512 = b11_route_times(view, xs, cs)
                b11_wgmma[(model, n)].update(ms_at_512=t512["wgmma"][0],
                                             simt_ms_at_512=t512["simt"][0])
                log(f"  at N={TRAIN_BATCH}: wgmma kernel {t512['wgmma'][0]:.4f} ms, simt kernel "
                    f"{t512['simt'][0]:.4f} ms")

    # -- phase 14: serving the mixture-density models through CompiledFlow ------------
    # log_prob is one B11 launch; sample runs the model's sequential sampler
    # (no kernel of the port) and sample_and_log_prob adds one B11 for the
    # samples' log_prob; the unfused path is cuBLAS only
    serve("MoG-MADE", mog, DM, "B11", {}, {}, fused_sample=dict(B11=1))
    serve("MADEMoG, context", mog_ctx, DM, "B11", {}, {}, fused_sample=dict(B11=1),
          context_features=MOG_CONTEXT)

    # -- phase 15: B12 against its plain version (full-width MADEMoG) -------------------
    # at the cluster size its wrapper chooses and at every other one: one
    # block a tile (csrc/mademog_train.cu) and clusters of 2, 4 and 8 blocks
    # (csrc/mademog_train_cluster.cu), each held in the same bands and timed
    def b12_occupancy(cf):
        """The clusters of each size of B12's cluster kernel the card holds
        at once, at the MADEMoG's shared memory (context ``cf`` or None)."""
        return {c: mademog_train.active_clusters(dev, cf, c, mademog_train.shared_memory_bytes(
            DM, cf or 0, MOG["num_mixture_components"], MOG["hidden_features"], c))
            for c in mademog_train.CLUSTER_SIZES}

    b12 = {}
    gstacks = mademog_fused.WEIGHT_KEYS + mademog_fused.CONTEXT_KEYS
    for model, dist, cf in mog_models:
        mtr = fused_trainer(dist, TRAIN_BATCH)
        if not isinstance(mtr, mademog_train.FusedMADEMoGTrainer):
            raise AssertionError(f"fused_trainer gave {type(mtr).__name__} for the {model}")
        f32 = {k: v.detach().contiguous() for k, v in mtr._fold(mtr.weights).items()}
        f64 = {k: v.double() for k, v in f32.items()}
        mpacked = mademog_fused.pack_weights(f32, mtr._static)
        mog_bytes = 4 * sum(v.numel() for v in f32.values())
        active = b12_occupancy(cf)
        # the inputs at 2,048 come from a generator of their own, so that the
        # shared one draws what it drew before that size was added
        for n in (TRAIN_BATCH, 2048, SERVE_BATCH, RAGGED):
            draw = torch.Generator().manual_seed(n) if n == 2048 else gen
            x = (1.5 * torch.randn(n, DM, generator=draw)).to(dev)
            c = None if cf is None else torch.randn(n, cf, generator=draw).to(dev)
            glp = (torch.randn(n, generator=draw) / n).to(dev)
            chosen, grid = mademog_train.launch_layout(n, mtr._static, cf, dev)
            log(f"B12 on the {model} at N={n}: {-(-n // 32)} tiles of 32 samples, cluster size "
                f"{chosen} (grid {grid}); active clusters by size {active}")
            p_gx, p_gctx, p_grads = mademog_train.mademog_train_bwd_plain(
                x, glp, f32, mtr._static, c)
            d_gx, d_gctx, d_grads = mademog_train.mademog_train_bwd_plain(
                x.double(), glp.double(), f64, mtr._static, None if c is None else c.double())
            log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")
            errs = []
            for cs in (chosen, *(s for s in (1, *mademog_train.CLUSTER_SIZES) if s != chosen)):
                ind = "" if cs == chosen else "  "
                if cs != chosen:
                    log(f"  cluster size {cs}:")
                gx, gctx, grads = mademog_train.mademog_train_bwd_cuda(
                    x, glp, f32, mtr._static, c, cluster=cs)
                torch.cuda.synchronize()
                outs = [gx, *grads.values()] + ([] if gctx is None else [gctx])
                if not all(torch.isfinite(t).all() for t in outs):
                    raise AssertionError(f"B12 at cluster size {cs} produced non-finite values")
                errs.append(hold(f"{ind}gx * N", gx * n, p_gx * n, d_gx * n, 5e-3))
                if cf is not None:
                    errs.append(hold(f"{ind}gctx * N", gctx * n, p_gctx * n, d_gctx * n, 5e-3))
                errs += [hold(f"{ind}g{k}", grads[k], p_grads[k], d_grads[k], 2e-4)
                         for k in gstacks if k in grads]
            if n == RAGGED:
                continue
            run = lambda: mademog_train.mademog_train_bwd_cuda(  # noqa: E731
                x, glp, f32, mtr._static, c, packed=mpacked, grads=grads)  # noqa: B023
            run_plain = lambda: mademog_train.mademog_train_bwd_plain(  # noqa: E731
                x, glp, f32, mtr._static, c)  # noqa: B023
            ms = device_ms(torch, run, 10, kernel="mademog_train_bwd")
            ms_source = device_ms.source
            by_cluster = {cs: device_ms(torch, lambda: mademog_train.mademog_train_bwd_cuda(
                x, glp, f32, mtr._static, c, packed=mpacked, grads=grads,  # noqa: B023
                cluster=cs), 10, kernel="mademog_train_bwd")  # noqa: B023
                for cs in (1, *mademog_train.CLUSTER_SIZES)}
            plain_ms = device_ms(torch, run_plain, 3)
            # recompute, input cotangents and weight gradients, each over the
            # weights the masks leave and the context weights; the kernel runs
            # the three dense
            need, dense = (3 * v for v in mog_ops(dist, n))
            io_bytes = 2 * mog_bytes + 4 * n * (2 * DM + 2 * (cf or 0) + 1)
            bound_ms, bound_by = bound(need, io_bytes)
            log(f"  time: kernel {ms:.4f} ms (cluster size {chosen})  plain {plain_ms:.4f} ms  "
                f"bound {bound_ms:.4f} ms ({bound_by}, {need / 1e9:.2f} GFLOP needed); the "
                f"kernel's schedule multiplies {dense / 1e9:.2f} GFLOP "
                f"({bound(dense, io_bytes)[0]:.4f} ms at the peak rate), "
                f"{dense / ms / 1e9:.1f} TFLOP/s; by cluster size "
                f"{json.dumps({cs: round(v, 4) for cs, v in by_cluster.items()})}, one block a "
                f"tile {by_cluster[1]:.4f} ms")
            b12[(model, n)] = dict(err=max(errs), ms=ms, ms_source=ms_source,
                                   plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                   schedule_ms=bound(dense, io_bytes)[0], cluster_size=chosen,
                                   ms_by_cluster_size=by_cluster, active_clusters=active)

    # -- phase 16: training the mixture-density models on the card --------------------
    def mog_routes(dist, n):
        fused_tr = fused_trainer(copy.deepcopy(dist), n)
        state = create_train_state(copy.deepcopy(dist).train(), adam)
        eager_step = make_train_step()
        steps = {"fused": fused_tr.make_train_step(fused_tr.init_opt(adam)),
                 "eager": lambda batch, c=None: eager_step(state, batch, c)[1]["loss"]}
        return steps, fused_tr, state

    b12_phase_launches = {}   # B12's launches a fused step by cluster size, by model
    b11_trainer_weights = {}  # B11 on both routes on the trained weights, by model
    mog_trained = {}          # the trained model, its held batch and context, by model
    b12_step_clusters = {}    # B12's cluster size and the fused step's ms by batch

    def b12_step_cluster(n, trainer):
        chosen, grid = mademog_train.launch_layout(n, trainer._static,
                                                   trainer.context_features, dev)
        log(f"  batch {n}: the fused step's B12 runs {-(-n // 32)} tiles of 32 samples at "
            f"cluster size {chosen} (grid {grid})")
        return chosen

    for model, dist, cf in mog_models:
        steps, fused_tr, state = mog_routes(dist, TRAIN_BATCH)
        start = {k: v.detach().clone() for k, v in fused_tr.weights.items()}
        data = ar_batches(TRAIN_BATCH, TRAIN_STEPS, 9, cf)
        losses = {}
        for name, expected in (("fused", dict(B11=1, B11_simt=1, B12=1)), ("eager", {})):
            reset_counts()
            first = steps[name](*data[0])
            torch.cuda.synchronize()
            counts = read_counts()
            log(f"training the {model} ({name}): launches a step {counts}")
            expect_counts(f"one {name} {model} step", counts, **expected)
            if name == "fused":
                launches.setdefault("B12", counts["B12"])
                # the step's forward is B11's SIMT kernel (the trainer re-packs
                # its weights every step)
                launches.setdefault("B11_simt", counts["B11_simt"])
                # B12 ran once, at the cluster size its wrapper chooses
                by_size = {cs: v for cs, v in mademog_train.cluster_launch_count.items() if v}
                chosen = b12_step_cluster(TRAIN_BATCH, fused_tr)
                log(f"  its B12: launches by cluster size {by_size}")
                if by_size != {chosen: 1}:
                    raise AssertionError(f"the {model} step ran B12 {by_size}, expected once at "
                                         f"cluster size {chosen}")
                b12_phase_launches[f"{model} train"] = by_size
            rest = [steps[name](*batch) for batch in data[1:]]
            losses[name] = [float(v) for v in [first, *rest]]
            log(f"  {TRAIN_STEPS} Adam steps (lr 3e-4, batch {TRAIN_BATCH}): loss "
                f"{losses[name][0]:.4f} -> {losses[name][-1]:.4f}")
            if not all(np.isfinite(losses[name])) or not losses[name][-1] < losses[name][0]:
                raise AssertionError(f"{model} {name}: the loss is not finite and falling: "
                                     f"{losses[name]}")
        gap = max(abs(a - b) for a, b in zip(losses["fused"][:3], losses["eager"][:3]))
        log(f"  first three losses, fused vs eager: {gap:.3e} apart (limit 2e-3)")
        if gap > 2e-3:
            raise AssertionError(f"the fused and eager {model} routes disagree at the start")
        for k in mademog_fused.MASKED_KEYS:
            dead = fused_tr._masks[k] == 0
            moved = not torch.equal(fused_tr.weights[k].detach()[dead], start[k][dead])
            live = not torch.equal(fused_tr.weights[k].detach()[~dead], start[k][~dead])
            log(f"  {k}: {int(dead.sum())} masked entries bit-equal after {TRAIN_STEPS} "
                f"steps: {not moved}; the others moved: {live}")
            if moved or not live:
                raise AssertionError(f"{model} {k}: masked entries moved, or nothing trained")
        held, held_c = ar_batches(TRAIN_BATCH, 1, 10, cf)[0]
        trained = fused_tr.to_dist().eval()
        served_lp = CompiledFlow(trained, batch_size=TRAIN_BATCH, features=DM,
                                 context_features=cf).log_prob(held, held_c)
        with torch.no_grad():
            trainer_lp = fused_tr._apply(fused_tr.weights, held, held_c)
        gap = max_err(served_lp, trainer_lp)
        log(f"  to_dist() served through CompiledFlow vs the trainer's log_prob: {gap:.3e} "
            "(limit 1e-3)")
        if gap > 1e-3:
            raise AssertionError(f"the trained {model} served disagrees with the trainer")
        log(f"  fused-trained vs eager-trained log_prob after {TRAIN_STEPS} steps: "
            f"{max_err(served_lp, state.flow.log_prob(held, held_c).detach()):.3e}")
        # B11 on both routes on the trained model, as it is served (the wgmma
        # route) and as the step runs it (SIMT), at the training batch; its
        # bf16 view is held in phase 31
        trained_view = mademog_fused.fuse_mademog(trained)
        mog_trained[model] = (trained, held, held_c)
        log(f"B11 on the trained {model} at N={TRAIN_BATCH}:")
        t_errs = b11_routes("trained", trained_view, held, held_c)
        t_times = b11_route_times(trained_view, held, held_c)
        log(f"  wgmma kernel {t_times['wgmma'][0]:.4f} ms, simt kernel "
            f"{t_times['simt'][0]:.4f} ms")
        b11_trainer_weights[model] = dict(err=t_errs["wgmma"], simt_err=t_errs["simt"],
                                          wgmma_ms=t_times["wgmma"][0],
                                          simt_ms=t_times["simt"][0])

        def timed_routes(n, dist=dist, cf=cf):
            steps, fused_tr, _ = mog_routes(dist, n)
            return steps, ar_batches(n, 4, 11, cf), fused_tr

        def fold(n, fused_tr, steps, args, cf=cf, model=model):
            ms = device_ms(torch, lambda: fused_tr._repack(fused_tr._fold(fused_tr.weights)), 20)
            log(f"  batch {n}: folding the masks and re-packing the weights {ms:.4f} ms a step")
            b12_step_clusters[f"{model} train"][n] = {
                "cluster_size": b12_step_cluster(n, fused_tr)}
            if n == TRAIN_BATCH and cf is None:
                host_ops(lambda: steps["fused"](*args[0]))

        title = f"{model} train"
        b12_step_clusters[title] = {}
        walls = time_steps(title, timed_routes, "mademog", extra=fold)
        for n, layout in b12_step_clusters[title].items():
            layout.update(fused_step_ms=walls[("fused", n)],
                          fused_step_busy_ms=step_busy[(title, "fused", n)])

    # -- phase 17: B5-B8 against their plain versions (the other spline families) ----
    # family -> (kernel id, wrapper module, wrapper, plain version, kernel name,
    # parameters a feature, fp32 operations an element: forward, inverse)
    families = {
        "lrs": ("B5", lrs_spline, lrs_spline.lrs_spline_cuda,
                linear_rational.unconstrained_linear_rational_spline_plain,
                "lrs_spline_kernel", 4 * K - 1, 14 * K + 80, 14 * K + 80),
        "linear": ("B6", linear_spline, linear_spline.linear_spline_cuda,
                   linear.unconstrained_linear_spline_plain, "linear_spline_kernel",
                   K, 5 * K + 20, 6 * K + 20),
        "quadratic": ("B7", quadratic_spline, quadratic_spline.quadratic_spline_cuda,
                      quadratic.unconstrained_quadratic_spline_plain,
                      "quadratic_spline_kernel", 2 * K - 1, 16 * K + 40, 16 * K + 40),
        "cubic": ("B8", cubic_spline, cubic_spline.cubic_spline_cuda,
                  cubic.unconstrained_cubic_spline_plain, "cubic_spline_kernel",
                  2 * K + 2, 12 * K + 80, 12 * K + 80 + 9 * cubic.BISECTION_STEPS),
    }
    # phase 17's kernels on B1's group of lanes: their parameters' widths, the K held
    group_layouts = {"B5": (lambda k: (k, k, k - 1, k), B5_LAYOUT_BINS),
                     "B6": (lambda k: (k,), B6_LAYOUT_BINS),
                     "B7": (lambda k: (k, k - 1), B7_LAYOUT_BINS),
                     "B8": (lambda k: (k, k, 1, 1), B8_LAYOUT_BINS)}
    family_flows = {"lrs": NeuralSplineFlow(spline="lrs", **seeded(0), **FLAGSHIP).eval()}
    for fam in ("linear", "quadratic", "cubic"):
        family_flows[fam] = family_flow(fam, dev, seed=0)
    family_stats = {}
    for fam, (kid, module, wrapper, plain, kname, P, ops_fwd, ops_inv) in families.items():
        flow_f = family_flows[fam]
        family_stats[kid] = {}
        with torch.no_grad():
            for samples in (SERVE_BATCH, (1 << 20) // 3):
                args = family_inputs(fam, flow_f, torch.randn(samples, D, generator=gen).to(dev))
                args[0].view(-1)[:4] = torch.tensor([B, -B, B + 0.5, -B - 0.5])
                stress = [args[0], *(torch.randn(t.shape, generator=gen).to(dev)
                                     for t in args[1:])]
                n = args[0].numel()
                log(f"{kid} ({fam}) at {n} elements (the full-width flow's coupling 1, then "
                    "N(0,1) parameters):")
                errs, stats = [], {}
                for inverse in (False, True):
                    kw = dict(inverse=inverse, tail_bound=B)
                    tag = "inverse" if inverse else "forward"
                    for what, inputs, out_tol, lad_tol in (("", args, 1e-4, 1e-3),
                                                          ("stress ", stress, 1e-2, 1e-2)):
                        out, lad = wrapper(*inputs, **kw)
                        p_out, p_lad = plain(*inputs, **kw)
                        d_out, d_lad = plain(*[t.double() for t in inputs], **kw)
                        torch.cuda.synchronize()
                        if not (torch.isfinite(out).all() and torch.isfinite(lad).all()):
                            raise AssertionError(f"{kid} produced non-finite values")
                        e = [hold(f"{what}{tag} out", out, p_out, d_out, out_tol),
                             hold(f"{what}{tag} lad", lad, p_lad, d_lad, lad_tol)]
                        if not what:
                            errs += e
                    run = lambda: wrapper(*args, **kw)  # noqa: E731
                    run_plain = lambda: plain(*args, **kw)  # noqa: E731
                    ms = device_ms(torch, run, 100, kernel=kname)
                    ms_source = device_ms.source
                    plain_ms = device_ms(torch, run_plain, 10)
                    nbytes = 4 * n * (1 + P + 2)  # x and the parameters; out, lad
                    nops = n * (ops_inv if inverse else ops_fwd)
                    bound_ms, bound_by = bound(nops, nbytes)
                    log(f"  {tag} time: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound "
                        f"{bound_ms:.5f} ms ({bound_by}: {nbytes / n:.0f} B, {nops / n:.0f} "
                        "FLOP an element)")
                    pre = "inverse_" if inverse else ""
                    stats.update({pre + "ms": ms, pre + "ms_source": ms_source,
                                  pre + "plain_ms": plain_ms, pre + "bound_ms": bound_ms,
                                  pre + "bound_by": bound_by})
                family_stats[kid][n] = dict(err=max(errs), launch_floor_ms=launch_floor_ms,
                                            **stats)
        if kid in group_layouts:
            widths, held_bins = group_layouts[kid]
            family_stats[kid]["layouts_err"] = hold_layouts(
                torch, kid, wrapper, plain, widths, held_bins, dev)
        # gradients through the autograd Function: kernel forward, plain backward
        args = family_inputs(fam, flow_f, torch.randn(SERVE_BATCH, D, generator=gen).to(dev))
        for inverse in (False, True):
            leaves = [t.detach().clone().requires_grad_(True) for t in args]
            out, lad = wrapper(*leaves, inverse=inverse, tail_bound=B)
            (out * 1.3 + lad * 0.7).sum().backward()
            ref = [t.detach().clone().requires_grad_(True) for t in args]
            p_out, p_lad = plain(*ref, inverse=inverse, tail_bound=B)
            (p_out * 1.3 + p_lad * 0.7).sum().backward()
            gap = max(max_err(a.grad, b.grad) for a, b in zip(leaves, ref))
            log(f"  gradients through the wrapper ({'inverse' if inverse else 'forward'}) vs "
                f"the plain version's: {gap:.3e} (limit 1e-4)")
            if gap > 1e-4:
                raise AssertionError(f"{kid}: the wrapper's gradients disagree")

    # -- phase 18: serving the four families' full-width flows through CompiledFlow ---
    # fused: one B2 a request; unfused (use_fused=False): one launch of the
    # family's kernel in each of the 10 couplings
    for fam, flow_f in family_flows.items():
        kid = families[fam][0]
        serve(f"{fam} couplings", flow_f, D, "B2", {kid: L}, {kid: L},
              ties=SERVE_BATCH // 1000 if fam == "linear" else 0)

    # -- phase 19: training the four families at full width on the three routes --------
    # fused: one B3 a step; fused-autograd: one B2 and one B4; eager: one launch
    # of the family's kernel in each of the 10 couplings
    for fam, flow_f in family_flows.items():
        # the eager route timed at 512 only: an eager step at 4,096 took 4-6 s
        # to time on a slow host, and the flagship's stays timed there
        train_three_routes(f"{fam} couplings", flow_f, {families[fam][0]: L},
                           eager_at=(TRAIN_BATCH,))

    # -- phase 20: B2's other families against their plain versions ---------------------
    # the six stages this port added to B2 (lrs, linear, quadratic, cubic on the
    # family flows above; affine with both scale activations and additive on
    # RealNVP at the flagship's widths), forward and inverse at N = 4,096
    realnvp_flows = {variant: realnvp_flow(variant, dev, seed=0)
                     for variant in ("affine", "general", "additive")}
    b2_families = {}
    x = torch.randn(SERVE_BATCH, D, generator=gen).to(dev)
    for fam, flow_f in {**family_flows, **realnvp_flows}.items():
        view = fuse_nsf(flow_f)
        fw32, fidx, fstatic = view._weights, view._indices, view._static
        fw64 = {k: v.double() for k, v in fw32.items()}
        ftm = fw32["wf"].shape[1]
        fbytes = 4 * sum(v.numel() for v in fw32.values())
        fam_routes = b2_routes(fw32, fidx, fstatic["spline"])
        log(f"B2 ({fam}, TM {ftm}) at N={SERVE_BATCH}, routes {fam_routes}:")
        stats = {"gemm_route": fam_routes[0]}
        for inverse in (False, True):
            kw = dict(inverse=inverse, **fstatic)
            p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, fw32, fidx, **kw)
            d_y, d_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x.double(), fw64, fidx, **kw)
            tag = "inverse" if inverse else "forward"
            pre = "inverse_" if inverse else ""
            times = {}
            for gr in fam_routes:
                y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(x, fw32, fidx, packed=view._packed,
                                                              gemm=gr, **kw)
                torch.cuda.synchronize()
                if not (torch.isfinite(y).all() and torch.isfinite(lad).all()):
                    raise AssertionError(f"B2 ({fam}, {gr}) produced non-finite values")
                err = max(hold(f"{gr} {tag} out", y, p_y, d_y, 1e-3),
                          hold(f"{gr} {tag} lad", lad, p_lad, d_lad, 1e-3))
                run = lambda: nsf_flow_kernel.nsf_flow_kernel_cuda(  # noqa: E731
                    x, fw32, fidx, packed=view._packed, gemm=gr, **kw)  # noqa: B023
                times[gr] = device_ms(torch, run, 10, kernel=B2_KERNEL[gr])
                if gr == fam_routes[0]:
                    stats.update({pre + "err": err, pre + "ms": times[gr],
                                  pre + "ms_source": device_ms.source})
                else:
                    stats[pre + f"{gr}_ms"] = times[gr]
            run_plain = lambda: nsf_flow_kernel.nsf_flow_kernel_plain(  # noqa: E731
                x, fw32, fidx, **kw)  # noqa: B023
            plain_ms = device_ms(torch, run_plain, 3)
            nops = 2 * SERVE_BATCH * L * (Tid * H + 2 * nb * H * H + H * ftm)
            bnd = b2_bound(nops, fbytes + 4 * SERVE_BATCH * (2 * D + 1), fam_routes[0])
            log(f"  {tag} time: " + ", ".join(f"{gr} kernel {t:.4f} ms" for gr, t in times.items())
                + f"  plain {plain_ms:.4f} ms  bound {bnd['bound_ms']:.4f} ms "
                f"({bnd['bound_by']}, {bnd['bound_basis']}; CUDA cores "
                f"{bnd['cuda_core_bound_ms']:.4f})  {nops / 1e9:.2f} GFLOP, "
                f"{nops / times[fam_routes[0]] / 1e9:.1f} TFLOP/s")
            stats.update({pre + "plain_ms": plain_ms, **{pre + k: v for k, v in bnd.items()}})
        b2_families[fam] = stats

    # the narrow quadratic chain with unfolded weights and wh_scale: 2KT = 20
    # rows (T 5, K 2) against TM = 15 and a hidden width of 16; the kernel must
    # scale the 15 rows the chain has and touch nothing past them
    narrow = family_flow("quadratic", dev, seed=3, features=10, hidden_features=16,
                         num_layers=3, num_bins=2)
    nidx, nw, nstatic, _, _ = nsf_fused._extract(narrow, torch.float32, fold_wh_scale=False)
    nw64 = {k: v.double() for k, v in nw.items()}
    xn = torch.randn(RAGGED, 10, generator=gen).to(dev)
    wh = nsf_train.family_wh_scale(nstatic, 16)
    log(f"B2 (quadratic, unfolded weights, wh_scale {wh}) on a narrow chain at N={RAGGED}:")
    for inverse in (False, True):
        kw = dict(inverse=inverse, wh_scale=wh, **nstatic)
        y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(xn, nw, nidx, **kw)
        p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(xn, nw, nidx, **kw)
        d_y, d_lad = nsf_flow_kernel.nsf_flow_kernel_plain(xn.double(), nw64, nidx, **kw)
        torch.cuda.synchronize()
        tag = "inverse" if inverse else "forward"
        hold(f"{tag} out", y, p_y, d_y, 1e-4)
        hold(f"{tag} lad", lad, p_lad, d_lad, 1e-4)

    # -- phase 21: B3 and B4 for the other six stages ------------------------------------
    # the lrs, linear, quadratic and cubic stages' adjoints on the four family
    # flows, the affine and additive ones on RealNVP; their plain versions
    # timed at the training batch only (the kernels line reads no other; a
    # plain B3 or B4 at 2,048 and 4,096 took 3-6 s to time on a slow host)
    b3_families, b4_families = {}, {}
    for fam, flow_f in {**family_flows, **realnvp_flows}.items():
        log(f"B3 and B4 on the {fam} chain:")
        b3_families[fam], b4_families[fam] = hold_training_kernels(
            fused_trainer(flow_f, TRAIN_BATCH), TRAIN_SIZES, plain_sizes=(TRAIN_BATCH,))

    # the held tie (TIE_X): B4 on a batch of 64 rows from a generator of
    # their own with the tie's row at rows 0, 24 (its row in its tile then)
    # and 63, at one block a tile and at every cluster size, five launches
    # each. The launches give the same bits; the other rows hold the band; a
    # copy of the tie's row holds it too, or is a tie: the float64 cotangent
    # at the row moved by 1e-6 along one feature lies within the band of the
    # kernel's and moves by at least half the error
    log(f"B4 on the held tie (the cubic chain, TIE_X at N={TIE_N}):")
    tie_tr = fused_trainer(family_flows["cubic"], TRAIN_BATCH)
    tie_w = {k: v.detach() for k, v in tie_tr.weights.items()}
    tie_w64, tie_idx = {k: v.double() for k, v in tie_w.items()}, tie_tr._indices
    tie_kw = dict(wh_scale=tie_tr._wh_scale, **tie_tr._static)
    g_tie, copies = torch.Generator().manual_seed(TIE_N), [0, 24, 63]
    x = 1.5 * torch.randn(64, D, generator=g_tie)
    gy = torch.randn(64, D, generator=g_tie) / TIE_N
    glad = torch.randn(64, generator=g_tie) / TIE_N
    x[copies] = torch.tensor([float.fromhex(v) for v in TIE_X])
    gy[copies] = torch.tensor([float.fromhex(v) for v in TIE_GY])
    glad[copies] = float.fromhex(TIE_GLAD)
    x, gy, glad = x.to(dev), gy.to(dev), glad.to(dev)
    rest = [i for i in range(64) if i not in copies]
    p_gx, _ = nsf_train.nsf_train_bwd_plain(x, gy, glad, tie_w, tie_idx, **tie_kw)
    d_gx, _ = nsf_train.nsf_train_bwd_plain(x.double(), gy.double(), glad.double(), tie_w64,
                                            tie_idx, **tie_kw)
    m_gx, _ = moved_cotangents(
        lambda *a, **kw: nsf_train.nsf_train_bwd_plain(*a, tie_w64, tie_idx, **kw, **tie_kw),
        x[:1], gy[:1], glad[:1], 1e-6)
    moves = (m_gx - d_gx[:1]).abs().amax(1) * TIE_N   # the float64 cotangent's move
    tie = dict(plain_err=float((p_gx[0].double() - d_gx[0]).abs().max()) * TIE_N,
               largest_move=float(moves.max()), by_cluster_size={})
    for c in (1, *nsf_train.CLUSTER_SIZES):
        runs = [nsf_train.nsf_train_bwd_cuda(x, gy, glad, tie_w, tie_idx, rows=32, cluster=c,
                                             **tie_kw)[0] for _ in range(5)]
        torch.cuda.synchronize()
        gx = runs[0]
        if not all(torch.equal(r, gx) for r in runs[1:]):
            raise AssertionError(f"B4 on the held tie: launches at cluster size {c} differ")
        hold(f"cluster size {c}, the other rows: gx * N", gx[rest] * TIE_N, p_gx[rest] * TIE_N,
             d_gx[rest] * TIE_N, 5e-3)
        errs = []
        for i in copies:
            err = float((gx[i].double() - d_gx[i]).abs().max()) * TIE_N
            near = (m_gx - gx[i].double()).abs().amax(1) * TIE_N
            e = int(near.argmin())
            ok = err <= 5e-3 or (float(near[e]) <= 5e-3 and float(moves[e]) >= 0.5 * err)
            log(f"  row {i}: |kernel-f64| x N {err:.3e}; nearest float64 cotangent at the row "
                f"moved by {'+' if e % 2 else '-'}1e-6 along feature {e // 2}: {float(near[e]):.3e}"
                f", which moves by {float(moves[e]):.3e} there  {'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError("B4 on the held tie: an error that is not a tie")
            errs.append(err)
        tie["by_cluster_size"][c] = dict(
            err=max(errs), copies_bit_equal=all(torch.equal(gx[i], gx[0]) for i in copies))
        log(f"  cluster size {c}: copies of the row bit-equal: "
            f"{tie['by_cluster_size'][c]['copies_bit_equal']}; five launches bit-equal")

    # -- phase 22: serving RealNVP, NICE and the GENERAL-activation chain ----------------
    # fused: one B2 a request; unfused: plain tensor code, no kernel of the port
    for variant, flow_f in realnvp_flows.items():
        serve(f"RealNVP ({variant})", flow_f, D, "B2", {}, {})

    # -- phase 23: training RealNVP on the three routes ----------------------------------
    train_three_routes("RealNVP", realnvp_flows["affine"], {}, eager_at=(TRAIN_BATCH,))

    # -- phase 24: B2, B3 and B4 with a context against their plain versions -----------
    # the flagship's conditional twin (context 10, MOG_CONTEXT) with its blocks'
    # second linear layers redrawn (lively_blocks), then the same three kernels
    # on a conditional affine chain at RealNVP's widths (final weights x 0.1)
    C = MOG_CONTEXT

    def hold_b2_context(model, flow_c, sizes):
        """B2 with a context against its plain version, forward and inverse,
        at each batch size: errors, times and bounds at the first size."""
        view = fuse_nsf(flow_c)
        cw32, cidx, cstatic = view._weights, view._indices, view._static
        cw64 = {k: v.double() for k, v in cw32.items()}
        ctm = cw32["wf"].shape[1]
        cbytes = 4 * sum(v.numel() for v in cw32.values())
        stats, errs = {}, []
        for n in sizes:
            x = torch.randn(n, D, generator=gen).to(dev)
            ctx = torch.randn(n, C, generator=gen).to(dev)
            ctx_routes = b2_routes(cw32, cidx, cstatic["spline"])
            log(f"B2 ({model}, context {C}) at N={n}, routes {ctx_routes}:")
            stats["gemm_route"] = ctx_routes[0]
            for inverse in (False, True):
                kw = dict(inverse=inverse, **cstatic)
                p_y, p_lad = nsf_flow_kernel.nsf_flow_kernel_plain(x, cw32, cidx, context=ctx,
                                                                   **kw)
                d_y, d_lad = nsf_flow_kernel.nsf_flow_kernel_plain(
                    x.double(), cw64, cidx, context=ctx.double(), **kw)
                tag = "inverse" if inverse else "forward"
                pre = "inverse_" if inverse else ""
                times = {}
                for gr in ctx_routes:
                    y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(
                        x, cw32, cidx, packed=view._packed, context=ctx, gemm=gr, **kw)
                    torch.cuda.synchronize()
                    if not (torch.isfinite(y).all() and torch.isfinite(lad).all()):
                        raise AssertionError(f"B2 ({model}, context, {gr}) produced "
                                             "non-finite values")
                    err = max(hold(f"{gr} {tag} out", y, p_y, d_y, 1e-3),
                              hold(f"{gr} {tag} lad", lad, p_lad, d_lad, 1e-3))
                    errs.append(err)
                    if n != sizes[0]:
                        continue
                    run = lambda: nsf_flow_kernel.nsf_flow_kernel_cuda(  # noqa: E731
                        x, cw32, cidx, packed=view._packed, context=ctx, gemm=gr,  # noqa: B023
                        **kw)  # noqa: B023
                    times[gr] = device_ms(torch, run, 10, kernel=B2_KERNEL[gr])
                    if gr == ctx_routes[0]:
                        stats.update({pre + "err": err, pre + "ms": times[gr],
                                      pre + "ms_source": device_ms.source})
                    else:
                        stats[pre + f"{gr}_ms"] = times[gr]
                if n != sizes[0]:
                    continue
                run_plain = lambda: nsf_flow_kernel.nsf_flow_kernel_plain(  # noqa: E731
                    x, cw32, cidx, context=ctx, **kw)  # noqa: B023
                plain_ms = device_ms(torch, run_plain, 3)
                nops = 2 * n * L * (Tid * H + C * H + 2 * nb * H * H + nb * C * H + H * ctm)
                bnd = b2_bound(nops, cbytes + 4 * n * (2 * D + 1 + C), ctx_routes[0])
                log(f"  {tag} time: "
                    + ", ".join(f"{gr} kernel {t:.4f} ms" for gr, t in times.items())
                    + f"  plain {plain_ms:.4f} ms  bound {bnd['bound_ms']:.4f} ms "
                    f"({bnd['bound_by']}, {bnd['bound_basis']}; CUDA cores "
                    f"{bnd['cuda_core_bound_ms']:.4f})  {nops / 1e9:.2f} GFLOP, "
                    f"{nops / times[ctx_routes[0]] / 1e9:.1f} TFLOP/s")
                stats.update({pre + "plain_ms": plain_ms, **{pre + k: v for k, v in bnd.items()}})
        stats["err"] = max(errs)
        return stats

    def lively_blocks(flow_c, seed):
        """Redraw each residual block's second linear layer (a coupling's
        ResidualNet, an autoregressive layer's MADE, wrapped or not) at the
        first's scale: as the library initialises it (U(-1e-3, 1e-3), so
        that a layer starts near the identity) the gradients of the block's
        context gate or projection and of its first linear are near 1e-5,
        and a kernel fault in them would hide under the 2e-4 band. A trained
        model's are not."""
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for t in flow_c.transform.transforms:
                t = getattr(t, "transform", t)
                net = getattr(t, "transform_net", getattr(t, "autoregressive_net", None))
                for blk in getattr(net, "blocks", ()):
                    w = blk.linear_1.weight
                    bound_w = 1.0 / w.shape[1] ** 0.5
                    w.copy_(((torch.rand(w.shape, generator=g) * 2 - 1) * bound_w).to(dev))
        return flow_c

    cond_flow = NeuralSplineFlow(generator=torch.Generator().manual_seed(20),
                                 rng=np.random.default_rng(20), device=dev,
                                 context_features=C, **FLAGSHIP).eval()
    lively = lively_blocks(copy.deepcopy(cond_flow), seed=21)
    b2_ctx = hold_b2_context("conditional NSF", lively, (SERVE_BATCH, RAGGED))
    log(f"B3 and B4 on the conditional NSF (context {C}):")
    b3_ctx, b4_ctx = hold_training_kernels(fused_trainer(lively, TRAIN_BATCH), TRAIN_SIZES)

    # the held tie of the conditional flagship (TIE_CTX): B4 at its N on
    # inputs from a generator of their own with the tie's row at its sample,
    # at one block a tile and at every cluster size; gx and gctx of every
    # other sample hold the band, the tie's hold it or are a tie (hold_tie)
    n_t, s_t = TIE_CTX["n"], TIE_CTX["sample"]
    log(f"B4 on the held tie (the conditional flagship, TIE_CTX: sample {s_t} at N={n_t}):")
    ctie_tr = fused_trainer(lively, TRAIN_BATCH)
    ctie_w = {k: v.detach() for k, v in ctie_tr.weights.items()}
    ctie_w64, ctie_idx = {k: v.double() for k, v in ctie_w.items()}, ctie_tr._indices
    ctie_kw = dict(wh_scale=ctie_tr._wh_scale, **ctie_tr._static)
    g_t = torch.Generator().manual_seed(n_t + 1)
    x = 1.5 * torch.randn(n_t, D, generator=g_t)
    ctx_t = torch.randn(n_t, C, generator=g_t)
    gy = torch.randn(n_t, D, generator=g_t) / n_t
    glad = torch.randn(n_t, generator=g_t) / n_t
    x[s_t] = torch.tensor([float.fromhex(v) for v in TIE_CTX["x"]])
    gy[s_t] = torch.tensor([float.fromhex(v) for v in TIE_CTX["gy"]])
    ctx_t[s_t] = torch.tensor([float.fromhex(v) for v in TIE_CTX["ctx"]])
    glad[s_t] = float.fromhex(TIE_CTX["glad"])
    x, gy, glad, ctx_t = x.to(dev), gy.to(dev), glad.to(dev), ctx_t.to(dev)

    def back64(*a, **kw):
        return nsf_train.nsf_train_bwd_plain(*a, ctie_w64, ctie_idx, **kw, **ctie_kw)

    p_gx, p_g = nsf_train.nsf_train_bwd_plain(x, gy, glad, ctie_w, ctie_idx, context=ctx_t,
                                              **ctie_kw)
    d_gx, d_g = back64(x.double(), gy.double(), glad.double(), context=ctx_t.double())
    moved = {step: moved_cotangents(back64, x[s_t:s_t + 1], gy[s_t:s_t + 1],
                                    glad[s_t:s_t + 1], step, ctx_t[s_t:s_t + 1])
             for step in TIE_STEPS}
    ctx_tie = {}
    for c in (1, *nsf_train.CLUSTER_SIZES):
        gx, g_c = nsf_train.nsf_train_bwd_cuda(x, gy, glad, ctie_w, ctie_idx, rows=32,
                                               cluster=c, context=ctx_t, **ctie_kw)
        torch.cuda.synchronize()
        log(f"  cluster size {c}:")
        ctx_tie[c] = {
            "gx": hold_tie(torch, "gx * N", gx, p_gx, d_gx, lambda st: moved[st][0], n_t, s_t,
                           "  ")[1],
            "gctx": hold_tie(torch, "gctx * N", g_c["ctx"], p_g["ctx"], d_g["ctx"],
                             lambda st: moved[st][1]["ctx"], n_t, s_t, "  ")[1]}
    cond_affine = lively_blocks(realnvp_flow("affine", dev, seed=22, context_features=C), seed=23)
    b2_ctx_affine = hold_b2_context("conditional affine chain", cond_affine, (SERVE_BATCH,))
    log(f"B3 and B4 on the conditional affine chain (context {C}):")
    b3_ctx_affine, b4_ctx_affine = hold_training_kernels(
        fused_trainer(cond_affine, TRAIN_BATCH), TRAIN_SIZES, fresh=(2048, SERVE_BATCH))

    # -- phase 25: serving the conditional NSF through CompiledFlow ----------------------
    # log_prob of 4,096 samples with 4,096 context rows; sample 256 samples for
    # each of 16 context rows; fused (one B2 a request) against unfused (ten B1)
    serve("conditional NSF", cond_flow, D, "B2", dict(B1=L), dict(B1=L), context_features=C,
          context_rows=16)

    # -- phase 26: training the conditional NSF on the three routes ---------------------
    train_three_routes("conditional NSF", cond_flow, dict(B1=L), context_features=C)

    # -- phase 27: B9 and B10 with a context, and B10's inverse direction -----------
    # the full-width MAF and NSF-AR (MAF's and NSF_AR's widths) with a context of
    # MOG_CONTEXT features; the MAF's final MADE weights x 0.1, as phase 9's, and
    # an untamed one held by relative error; the IAF at the same widths,
    # unconditional (models.InverseAutoregressiveFlow) and with the context
    from nflows_tpu_torch import Flow
    from nflows_tpu_torch.distributions import StandardNormal
    from nflows_tpu_torch.transforms import (
        CompositeTransform,
        InverseTransform,
        MaskedAffineAutoregressiveTransform,
        ReversePermutation,
    )

    def ar_chain(seed, wrapped=False):
        """MAF's widths with a context: LA x [ReversePermutation, residual
        affine MADE with a context of C features], wrapped in InverseTransform
        for an IAF; random weights from ``seed``."""
        g = torch.Generator().manual_seed(seed)
        chain = []
        for _ in range(LA):
            layer = MaskedAffineAutoregressiveTransform(DA, HA, context_features=C,
                                                        num_blocks=nba, generator=g, device=dev)
            chain += [ReversePermutation(DA, device=dev),
                      InverseTransform(layer) if wrapped else layer]
        return Flow(CompositeTransform(chain), StandardNormal([DA])).to(dev).eval()

    # the flows whose kernels are held have their blocks redrawn (lively_blocks);
    # the untamed conditional MAF is held as the library initialises it
    raw_cmaf = ar_chain(30)
    cmaf = tame(lively_blocks(ar_chain(30), seed=34))
    cnsf_ar = lively_blocks(NeuralSplineFlowAR(**NSF_AR, context_features=C, **seeded(31)),
                            seed=35).eval()
    ciaf = tame(lively_blocks(ar_chain(32, wrapped=True), seed=36))
    iaf_full = tame(lively_blocks(InverseAutoregressiveFlow(**MAF, **seeded(33)), seed=37))

    def context_ops(n):
        """fp32 FLOP of the context projections of one MADE pass a layer."""
        return 2 * n * LA * (1 + nba) * C * HA

    view = fuse_maf(raw_cmaf)
    x = torch.randn(SERVE_BATCH, DA, generator=gen).to(dev)
    ctx = torch.randn(SERVE_BATCH, C, generator=gen).to(dev)
    kw = dict(inverse=True, context=ctx, num_blocks=view._num_blocks,
              transformer=view._transformer, spline_kw=view._spline_kw)
    hold_untamed_inverse(f" with context {C}", view, x, kw)
    log(f"B9's one pass on the conditional MAF as initialised at N={x.shape[0]}:")
    b9_untamed["conditional MAF"] = b9_one_pass("conditional MAF as initialised, forward",
                                                view, x, dict(kw, inverse=False))[1]
    # the conditional IAF's sampling direction (its one pass) on both
    # routes, on inputs from a generator of their own
    g_i = torch.Generator().manual_seed(27)
    view = fuse_maf(ciaf)
    for n in (SERVE_BATCH, RAGGED):
        x = torch.randn(n, DA, generator=g_i).to(dev)
        ctx = torch.randn(n, C, generator=g_i).to(dev)
        kw = dict(inverse=True, context=ctx, num_blocks=view._num_blocks,
                  transformer=view._transformer, spline_kw=view._spline_kw)
        log(f"B9 on the conditional IAF (context {C}) at N={n}, its sampling direction:")
        _, one = b9_one_pass("inverse", view, x, kw)
        if n == SERVE_BATCH:
            times = b9_route_times(view, x, kw)
            b9_wgmma["conditional IAF"] = dict(err=one["wgmma"], simt_err=one["simt"],
                                               ms=times["wgmma"][0], simt_ms=times["simt"][0])
            log(f"  time: wgmma kernel {times['wgmma'][0]:.4f} ms, simt kernel "
                f"{times['simt'][0]:.4f} ms")

    b9_ctx = {}
    for model, ar_flow in (("conditional MAF", cmaf), ("conditional NSF-AR", cnsf_ar)):
        view = fuse_maf(ar_flow)
        w32 = view._weights
        skw = dict(num_blocks=view._num_blocks, transformer=view._transformer,
                   spline_kw=view._spline_kw)
        P = w32["wf"].shape[0] // LA
        ar_bytes = 4 * sum(v.numel() for v in w32.values())
        need = masked_ops(1, ar_flow) + context_ops(1)
        stats = {}
        for n in (SERVE_BATCH, RAGGED):
            x = torch.randn(n, DA, generator=gen).to(dev)
            ctx = torch.randn(n, C, generator=gen).to(dev)
            log(f"B9 on the {model} (context {C}) at N={n}:")
            for inverse in (False, True):
                kw = dict(inverse=inverse, context=ctx, **skw)
                tag = "inverse" if inverse else "forward"
                if inverse:
                    y, lad, err, fp_err = hold_fixed_point(tag, view, x, kw)
                else:
                    (y, lad), one = b9_one_pass(tag, view, x, kw)
                    err, err_simt = one["wgmma"], one["simt"]
                back, lad_back = maf_flow_kernel.maf_flow_kernel_cuda(
                    y, w32, view._static, packed=view._packed, **{**kw, "inverse": not inverse})
                trip = max(max_err(back, x), max_err(lad_back, -lad))
                log(f"  {tag} then back: {trip:.3e} from the input (limit 5e-3)")
                if trip > 5e-3:
                    raise AssertionError(f"B9 {model}: the round trip does not close")
                if n != SERVE_BATCH:
                    continue
                nops = n * need
                io_bytes = ar_bytes + 4 * n * (2 * DA + 1 + C)
                if inverse:
                    stats.update(inverse_err=err, inverse_fixed_point_err=fp_err,
                                 **time_fixed_point(view, x, kw, nops, io_bytes,
                                                    (dense_ops(n, P) + context_ops(n))
                                                    * (DA + 1)))
                    continue
                run_plain = lambda: maf_flow_kernel.maf_flow_kernel_plain(  # noqa: E731
                    x, w32, view._static, **kw)  # noqa: B023
                times = b9_route_times(view, x, kw)
                ms, ms_source = times["simt"]
                plain_ms = device_ms(torch, run_plain, 3)
                run_ops = dense_ops(n, P) + context_ops(n)
                bound_ms, bound_by = bound(nops, io_bytes)
                wb = b9_route_bound(nops, run_ops, io_bytes)
                log(f"  {tag} time: wgmma kernel {times['wgmma'][0]:.4f} ms, simt kernel "
                    f"{ms:.4f} ms  plain {plain_ms:.4f} ms; bound on the wgmma route "
                    f"{wb['bound_ms']:.4f} ms ({wb['bound_by']}, {wb['bound_basis']}; the dense "
                    f"{run_ops / 1e9:.1f} GFLOP it multiplies {wb['dense_ms']:.4f} ms), on the "
                    f"CUDA cores {bound_ms:.4f} ms ({nops / 1e9:.2f} GFLOP needed)")
                stats.update(err=err_simt, ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by,
                             schedule_ms=bound(run_ops, io_bytes)[0])
                b9_wgmma[model] = dict(err=err, ms=times["wgmma"][0],
                                       ms_source=times["wgmma"][1], simt_ms=ms,
                                       plain_ms=plain_ms, **wb,
                                       untamed_err=b9_untamed.get(model, {}).get("wgmma"))
        b9_ctx[model] = stats

    def hold_b10(model, trainer, n, context_features, draw):
        """B10 on ``trainer``'s folded weights against its plain version at
        batch n (with N(0, 1) context rows where the trainer is
        conditional; inputs from the generator ``draw``), at the cluster
        size the wrapper chooses and, below the serving batch, at every
        other one: errors, times by cluster size, bound."""
        f32 = {k: v.detach().contiguous() for k, v in trainer._fold(trainer.weights).items()}
        f64 = {k: v.double() for k, v in f32.items()}
        mkw = dict(wh_scale=trainer._wh_scale, direction=trainer._direction, **trainer._static)
        x = (1.5 * torch.randn(n, DA, generator=draw)).to(dev)
        gy = (torch.randn(n, DA, generator=draw) / n).to(dev)
        glad = (torch.randn(n, generator=draw) / n).to(dev)
        ctx = (None if context_features is None
               else torch.randn(n, context_features, generator=draw).to(dev))
        rows, chosen, grid = maf_train.launch_layout(n, trainer._dims, dev)
        active = b10_occupancy(trainer._dims)
        log(f"B10 ({trainer._direction}) on the {model} at N={n}: {-(-n // rows)} tiles of "
            f"{rows} samples, cluster size {chosen} (grid {grid}); active clusters by size "
            f"{active}")
        gx, grads = maf_train.maf_train_bwd_cuda(x, gy, glad, f32, trainer._layers,
                                                 context=ctx, **mkw)
        p_gx, p_grads = maf_train.maf_train_bwd_plain(x, gy, glad, f32, trainer._layers,
                                                      context=ctx, **mkw)
        d_gx, d_grads = maf_train.maf_train_bwd_plain(
            x.double(), gy.double(), glad.double(), f64, trainer._layers,
            context=None if ctx is None else ctx.double(), **mkw)
        torch.cuda.synchronize()
        if not all(torch.isfinite(t).all() for t in (gx, *grads.values())):
            raise AssertionError("B10 produced non-finite values")
        log(f"  largest |gx * N|: {float((d_gx * n).abs().max()):.3f}")

        def check(c, gx, grads, ind=""):
            pairs = [("gx", gx, p_gx, d_gx)] + ([("gctx", grads["ctx"], p_grads["ctx"],
                                                  d_grads["ctx"])] if ctx is not None else [])
            errs = [hold(f"{ind}{k} * N", got * n, plain * n, exact * n, 5e-3)
                    for k, got, plain, exact in pairs]
            return errs + [hold(f"{ind}g{k}", grads[k], p_grads[k], d_grads[k], 2e-4, rel=1e-3)
                           for k in grads if k != "ctx"]

        errs = check(chosen, gx, grads)
        if n != SERVE_BATCH:
            errs += b10_every_cluster(chosen, lambda c: maf_train.maf_train_bwd_cuda(
                x, gy, glad, f32, trainer._layers, context=ctx, rows=32, cluster=c, **mkw),
                check)
        packed = maf_flow_kernel.pack_weights(f32, trainer._layers, nba)
        out = {k: v for k, v in grads.items() if k != "ctx"}
        run = lambda: maf_train.maf_train_bwd_cuda(  # noqa: E731
            x, gy, glad, f32, trainer._layers, context=ctx, packed=packed, grads=out, **mkw)
        run_plain = lambda: maf_train.maf_train_bwd_plain(  # noqa: E731
            x, gy, glad, f32, trainer._layers, context=ctx, **mkw)
        ms = device_ms(torch, run, 10, kernel="maf_train_bwd")
        ms_source = device_ms.source
        by_cluster = b10_cluster_times(lambda c: maf_train.maf_train_bwd_cuda(
            x, gy, glad, f32, trainer._layers, context=ctx, packed=packed, grads=out, rows=32,
            cluster=c, **mkw))
        plain_ms = device_ms(torch, run_plain, 3)
        P = trainer._dims["P"]
        w_bytes = 4 * sum(v.numel() for v in f32.values())
        cops = 0 if ctx is None else context_ops(n)
        nops = 3 * (n * masked_ops(1, trainer._flow_template) + cops)
        run_ops = 3 * (dense_ops(n, P) + cops)
        io_bytes = 2 * w_bytes + 4 * n * (3 * DA + 1 + (0 if ctx is None else 2 * C))
        bound_ms, bound_by = bound(nops, io_bytes)
        log(f"  time: kernel {ms:.4f} ms (cluster size {chosen})  plain {plain_ms:.4f} ms  "
            f"bound {bound_ms:.4f} ms ({bound_by}, {nops / 1e9:.2f} GFLOP needed); the "
            f"kernel's schedule multiplies {run_ops / 1e9:.1f} GFLOP "
            f"({bound(run_ops, io_bytes)[0]:.4f} ms at the peak rate), "
            f"{run_ops / ms / 1e9:.1f} TFLOP/s; by cluster size "
            f"{json.dumps({c: round(t, 4) for c, t in by_cluster.items()})}")
        return dict(err=max(errs), ms=ms, ms_source=ms_source, plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    schedule_ms=bound(run_ops, io_bytes)[0], cluster_size=chosen,
                    ms_by_cluster_size=by_cluster, active_clusters=active)

    # the inputs at 2,048 come from a generator of their own, so that the
    # shared one draws what it drew before that size was added
    b10_ctx, b10_inv = {}, {}
    for model, ar_flow, cf, sizes in (
            ("conditional MAF", cmaf, C, (TRAIN_BATCH, 2048, SERVE_BATCH)),
            ("conditional NSF-AR", cnsf_ar, C, (TRAIN_BATCH, 2048)),
            ("IAF", iaf_full, None, (TRAIN_BATCH, 2048, SERVE_BATCH)),
            ("conditional IAF", ciaf, C, (TRAIN_BATCH, 2048))):
        trainer = fused_trainer(ar_flow, TRAIN_BATCH)
        want = maf_train.FusedIAFTrainer if "IAF" in model else maf_train.FusedMAFTrainer
        if type(trainer) is not want:
            raise AssertionError(f"fused_trainer gave {type(trainer).__name__} for {model}")
        for n in sizes:
            draw = torch.Generator().manual_seed(n + len(model)) if n == 2048 else gen
            stats = hold_b10(model, trainer, n, cf, draw)
            (b10_inv if "IAF" in model else b10_ctx)[(model, n)] = stats

    # -- phase 28: serving the conditional MAF and NSF-AR through CompiledFlow ----------
    serve("conditional MAF", cmaf, DA, "B9", {}, {}, fused_sample=ar_sample,
          context_features=C, context_rows=16)
    serve("conditional NSF-AR", cnsf_ar, DA, "B9", dict(B1=LA), dict(B1=LA * DA),
          fused_sample=ar_sample, context_features=C, context_rows=16)
    serve("conditional IAF", ciaf, DA, "B9", {}, {}, fused_sample=ar_sample,
          context_features=C, context_rows=16, draw=torch.Generator().manual_seed(28))

    # -- phase 29: training the conditional MAF on the card ----------------------------
    train_ar("conditional MAF", cmaf, context_features=C)

    # -- phase 30: training the IAF by reverse KL on the card ---------------------------
    # target: a correlated Gaussian N(mu, Sigma) in 10 dimensions, mu and Sigma
    # fixed from a seed; its unnormalised log-density is the objective's
    g_t = torch.Generator().manual_seed(40)
    mu = torch.randn(DA, generator=g_t).to(dev)
    root = torch.randn(DA, DA, generator=g_t) / DA ** 0.5
    sigma = (root @ root.T + 0.5 * torch.eye(DA)).double()
    prec = torch.linalg.inv(sigma).float().to(dev)
    # the reverse KL's floor: E_q[log q - log p~] >= -log Z
    kl_floor = float(-0.5 * DA * np.log(2 * np.pi) - 0.5 * torch.logdet(sigma))

    def target_log_prob(v):
        d = v - mu
        return -0.5 * ((d @ prec) * d).sum(dim=1)

    vi_adam = lambda params: torch.optim.Adam(params, lr=1e-3)  # noqa: E731

    def eager_vi(model_flow, n, optimizer=vi_adam):
        """The eager reverse-KL step: noise from the generator, autograd
        through the unfused ``transform.inverse``, Adam on the flow's
        parameters."""
        f = copy.deepcopy(model_flow).train()
        opt = optimizer(list(f.parameters()))

        def step(generator, c=None):
            z = torch.randn(n, DA, generator=generator, device=dev)
            x, lad = f.transform.inverse(z, c)
            lq = -0.5 * (z * z).sum(dim=1) - 0.5 * DA * np.log(2 * np.pi) - lad
            loss = (lq - target_log_prob(x)).mean()
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            return loss.detach()

        return step, f

    def iaf_routes(model_flow, n):
        tr = fused_trainer(copy.deepcopy(model_flow), n)
        if not isinstance(tr, maf_train.FusedIAFTrainer):
            raise AssertionError(f"fused_trainer gave {type(tr).__name__} for the IAF")
        eager_step, _ = eager_vi(model_flow, n)
        return {"fused": tr.make_vi_train_step(tr.init_opt(vi_adam), target_log_prob),
                "eager": eager_step}, tr

    def moments(tr, weights=None, c=None):
        z = torch.randn(1 << 16, DA, generator=torch.Generator(device=dev).manual_seed(41),
                        device=dev)
        with torch.no_grad():
            x, _ = tr.sample_and_log_prob_fn(tr.weights if weights is None else weights, z, c)
        cov = torch.cov(x.double().T)
        return (float((x.double().mean(0) - mu.double()).abs().max()),
                float((cov - sigma.to(dev)).abs().max()))

    steps, iaf_tr = iaf_routes(iaf_full, TRAIN_BATCH)
    start_moments = moments(iaf_tr)
    vi_losses = {}
    for name, expected in (("fused", dict(B9=1, B9_simt=1, B10=1)), ("eager", {})):
        gens = [torch.Generator(device=dev).manual_seed(50 + i) for i in range(TRAIN_STEPS)]
        reset_counts()
        first = steps[name](gens[0])
        torch.cuda.synchronize()
        counts = read_counts()
        log(f"training the IAF by reverse KL ({name}): launches a step {counts}")
        expect_counts(f"one {name} IAF step", counts, **expected)
        if name == "fused":
            vi_launches = counts["B10"]
            b10_step_layout("IAF reverse-KL", iaf_tr, TRAIN_BATCH)
        rest = [steps[name](g) for g in gens[1:]]
        vi_losses[name] = [float(v) for v in [first, *rest]]
        log(f"  {TRAIN_STEPS} Adam steps (lr 1e-3, batch {TRAIN_BATCH}): loss "
            f"{vi_losses[name][0]:.4f} -> {vi_losses[name][-1]:.4f} (floor {kl_floor:.4f})")
        if (not all(np.isfinite(vi_losses[name]))
                or not np.mean(vi_losses[name][-5:]) < np.mean(vi_losses[name][:5])):
            raise AssertionError(f"IAF {name}: the loss is not finite and falling: "
                                 f"{vi_losses[name]}")
    gap = max(abs(a - b) for a, b in zip(vi_losses["fused"][:3], vi_losses["eager"][:3]))
    log(f"  first three losses, fused vs eager: {gap:.3e} apart (limit 2e-3)")
    if gap > 2e-3:
        raise AssertionError("the fused and eager IAF routes disagree")
    for k in maf_train.MASKED_KEYS:
        if iaf_tr.weights[k].grad[iaf_tr._masks[k] == 0].any():
            raise AssertionError(f"IAF {k}: a masked entry has a gradient")
    # fit the target: 400 more fused steps, then compare the moments
    fit_gen = torch.Generator(device=dev).manual_seed(60)
    t0 = time.perf_counter()
    fit = [float(steps["fused"](fit_gen)) for _ in range(400)]
    fit_s = time.perf_counter() - t0
    end_moments = moments(iaf_tr)
    log(f"  400 more fused steps in {fit_s:.2f} s: loss {np.mean(fit[:20]):.4f} -> "
        f"{np.mean(fit[-20:]):.4f} (floor {kl_floor:.4f}); over 65,536 samples, largest "
        f"|mean - mu| {start_moments[0]:.3f} -> {end_moments[0]:.3f}, largest "
        f"|cov - Sigma| {start_moments[1]:.3f} -> {end_moments[1]:.3f}")
    if not (np.mean(fit[-20:]) < np.mean(fit[:20]) and end_moments[0] < 0.5 * start_moments[0]
            and end_moments[1] < start_moments[1]):
        raise AssertionError("the IAF's reverse-KL fit did not move toward the target")
    trained_iaf = iaf_tr.to_flow().eval()
    zs = torch.randn(TRAIN_BATCH, DA, generator=gen).to(dev)
    with torch.no_grad():
        fx, flq = iaf_tr.sample_and_log_prob_fn(iaf_tr.weights, zs)
        ux, ulad = trained_iaf.transform.inverse(zs)
    gap = max(max_err(fx, ux),
              max_err(flq, -0.5 * (zs * zs).sum(1) - 0.5 * DA * np.log(2 * np.pi) - ulad))
    log(f"  to_flow() samples and log q vs the trainer's: {gap:.3e} (limit 1e-3)")
    if gap > 1e-3:
        raise AssertionError("the trained IAF's to_flow() disagrees with the trainer")

    # the conditional IAF: one B9 and one B10 a step, the loss falling
    ctr = fused_trainer(copy.deepcopy(ciaf), TRAIN_BATCH)
    cstep = ctr.make_vi_train_step(ctr.init_opt(vi_adam), target_log_prob)
    cgen = torch.Generator(device=dev).manual_seed(70)
    cctx = torch.randn(TRAIN_BATCH, C, generator=cgen, device=dev)
    reset_counts()
    first = cstep(cgen, cctx)
    torch.cuda.synchronize()
    counts = read_counts()
    expect_counts("one conditional IAF step", counts, B9=1, B9_simt=1, B10=1)
    b10_step_layout("conditional IAF reverse-KL", ctr, TRAIN_BATCH)
    closs = [float(first)] + [float(cstep(cgen, cctx)) for _ in range(TRAIN_STEPS - 1)]
    log(f"training the conditional IAF (context {C}) by reverse KL: launches a step {counts}; "
        f"loss {closs[0]:.4f} -> {closs[-1]:.4f}")
    if not all(np.isfinite(closs)) or not np.mean(closs[-5:]) < np.mean(closs[:5]):
        raise AssertionError(f"conditional IAF: the loss is not finite and falling: {closs}")

    def timed_vi_routes(n):
        steps, tr = iaf_routes(iaf_full, n)
        return steps, [(torch.Generator(device=dev).manual_seed(80 + i),) for i in range(4)], tr

    def vi_host_ops(n, tr, steps, args):
        b10_step_clusters["IAF reverse-KL"][n] = b10_step_cluster(n, tr)
        if n == TRAIN_BATCH:
            log(f"the IAF's fused reverse-KL step at batch {n}:")
            host_ops(lambda: steps["fused"](*args[0]))

    b10_step_clusters["IAF reverse-KL"] = {}
    walls = time_steps("IAF reverse-KL", timed_vi_routes, "iaf", extra=vi_host_ops)
    for n, layout in b10_step_clusters["IAF reverse-KL"].items():
        layout["fused_step_ms"] = walls[("fused", n)]

    # -- phase 31: bf16 weights: B2, B9 and B11 against their bf16 plain versions ----
    # the JAX package's default deployment (fuse_*(dtype=bfloat16)) on the
    # flagship (N = 4,096 and 65,536), RealNVP and the conditional flagship
    # (B2), the MAF, the NSF-AR and the conditional MAF (B9), the MoG-MADE and
    # the conditional MADEMoG (B11), forward and inverse at 4,096
    BF16 = torch.bfloat16
    BF16_OUT, BF16_LAD = 5e-3, 2e-2   # benchmarks/hw_numerics.py:68-123

    def hold_bf16(name, kernel, plain16, plain32, band):
        """A bf16 kernel against its bf16 plain version: max |delta| within
        ``band``, and mean |delta| at most a quarter of its mean |delta| to
        the fp32 plain version (it rounds where the JAX kernel rounds). The
        plain versions' own gap is logged: the price of bf16, not a gate."""
        diff16 = (kernel.double() - plain16.double()).abs()
        mean32 = float((kernel.double() - plain32.double()).abs().mean())
        err, mean16 = float(diff16.max()), float(diff16.mean())
        ok = bool(torch.isfinite(kernel).all()) and err <= band and mean16 <= 0.25 * mean32
        log(f"  {name}: |kernel-plain16| max {err:.3e} (band {band:.0e}), mean {mean16:.3e}; "
            f"|kernel-plain32| mean {mean32:.3e} (ratio {mean16 / max(mean32, 1e-30):.4f}, "
            f"limit 0.25); bf16's price |plain16-plain32| max {max_err(plain16, plain32):.3e}"
            f"  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: the bf16 kernel disagrees with its bf16 plain version")
        return err

    def bound_bf16(nops, weights, n_io):
        """The card's least time for the same work with bf16 operands: the
        operations over the dense bf16 tensor-core rate, or the bytes (bf16
        matrices, fp32 biases, fp32 inputs and outputs) over the memory rate."""
        nbytes = sum(v.numel() * v.element_size() for v in weights.values()) + 4 * n_io
        by_ops = nops / PEAK_BF16_FLOPS >= nbytes / PEAK_BYTES
        return (1e3 * max(nops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES),
                "operations" if by_ops else "bytes")

    def time_pair(run16, run32, runp, kernel, iters=10):
        """Device ms of the bf16 kernel, the fp32 one and the bf16 plain version."""
        ms16 = device_ms(torch, run16, iters, kernel=kernel)
        source = device_ms.source
        ms32 = device_ms(torch, run32, iters, kernel=kernel)
        return dict(ms=ms16, ms_source=source, fp32_ms=ms32, plain_ms=device_ms(torch, runp, 3))

    def b2_bf16(model, flow_b, sizes, context_features=None):
        """B2 with bf16 weights on both routes against the bf16 plain
        version, forward and inverse at each size (and at a ragged N on the
        flagship); timed at the given sizes beside the fp32 kernel of the
        same route and the bf16 SIMT kernel."""
        v16, v32 = fuse_nsf(flow_b, dtype=BF16), fuse_nsf(flow_b)
        w16, idx16, st = v16._weights, v16._indices, v16._static
        Tid_b, T_b = len(idx16[0].id_idx), len(idx16[0].tr_idx)
        H_b, TM_b = w16["w0"].shape[1], w16["wf"].shape[1]
        nb_b, L_b, C_b = st["num_blocks"], len(idx16), context_features or 0
        routes16 = b2_routes(w16, idx16, st["spline"])
        route32 = nsf_flow_kernel.weights_route(v32._weights, idx16, spline=st["spline"])
        stats = {}
        for n in sizes + ((RAGGED,) if model == "flagship" else ()):
            # the ragged N from a generator of its own, as in phase 4
            draw = torch.Generator().manual_seed(n) if n == RAGGED else gen
            x = torch.randn(n, Tid_b + T_b, generator=draw).to(dev)
            ctx = None if not C_b else torch.randn(n, C_b, generator=draw).to(dev)
            log(f"B2 in bf16 ({model}) at N={n}, routes {routes16}:")
            errs = []
            for inverse in (False, True):
                kw = dict(inverse=inverse, context=ctx, **st)
                p16 = nsf_flow_kernel.nsf_flow_kernel_plain(x, w16, idx16, **kw)
                p32 = nsf_flow_kernel.nsf_flow_kernel_plain(x, v32._weights, idx16, **kw)
                tag = "inverse" if inverse else "forward"
                for gr in routes16:
                    y, lad = nsf_flow_kernel.nsf_flow_kernel_cuda(
                        x, w16, idx16, packed=v16._packed, gemm=gr, **kw)
                    torch.cuda.synchronize()
                    errs.append(hold_bf16(f"{gr} {tag} out", y, p16[0], p32[0], BF16_OUT))
                    errs.append(hold_bf16(f"{gr} {tag} lad", lad, p16[1], p32[1], BF16_LAD))
            if n == RAGGED:
                continue
            out = {"gemm_route": routes16[0]}
            for inverse in (False, True):
                kw = dict(inverse=inverse, context=ctx, **st)
                t = {}
                for gr in routes16:
                    t["ms" if gr == routes16[0] else f"{gr}_ms"] = device_ms(
                        torch, lambda: nsf_flow_kernel.nsf_flow_kernel_cuda(  # noqa: B023
                            x, w16, idx16, packed=v16._packed, gemm=gr, **kw),  # noqa: B023
                        10, kernel=B2_KERNEL[gr])
                    if gr == routes16[0]:
                        t["ms_source"] = device_ms.source
                t["fp32_ms"] = device_ms(
                    torch, lambda: nsf_flow_kernel.nsf_flow_kernel_cuda(  # noqa: B023
                        x, v32._weights, idx16, packed=v32._packed, **kw),  # noqa: B023
                    10, kernel=B2_KERNEL[route32])
                t["plain_ms"] = device_ms(
                    torch, lambda: nsf_flow_kernel.nsf_flow_kernel_plain(  # noqa: B023
                        x, w16, idx16, **kw), 3)  # noqa: B023
                out.update(t if not inverse else {f"inverse_{k}": v for k, v in t.items()})
            nops = 2 * n * L_b * (Tid_b * H_b + C_b * H_b + 2 * nb_b * H_b * H_b
                                  + nb_b * C_b * H_b + H_b * TM_b)
            bound_ms, bound_by = bound_bf16(nops, w16, n * (2 * (Tid_b + T_b) + 1 + C_b))
            simt = (f", bf16 simt kernel {out['simt_ms']:.4f} / {out['inverse_simt_ms']:.4f} ms"
                    if "simt_ms" in out else "")
            log(f"  time (forward / inverse): bf16 {routes16[0]} kernel {out['ms']:.4f} / "
                f"{out['inverse_ms']:.4f} ms{simt}, fp32 {route32} kernel {out['fp32_ms']:.4f} / "
                f"{out['inverse_fp32_ms']:.4f} ms, bf16 plain {out['plain_ms']:.4f} / "
                f"{out['inverse_plain_ms']:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
                f"{nops / 1e9:.2f} GFLOP at 989 TFLOP/s): {100 * bound_ms / out['ms']:.2f}% "
                "of it")
            stats[n] = dict(err=max(errs), bound_ms=bound_ms, bound_by=bound_by,
                            bound_basis="bf16 tensor cores, 989 TFLOP/s", **out)
        return stats

    b2_bf16_stats = b2_bf16("flagship", flow, (SERVE_BATCH, 1 << 16))
    b2_bf16_affine = b2_bf16("RealNVP", realnvp_flows["affine"], (SERVE_BATCH,))[SERVE_BATCH]
    b2_bf16_ctx = b2_bf16("conditional flagship", cond_flow, (SERVE_BATCH,),
                          context_features=C)[SERVE_BATCH]

    def hold_bf16_fixed_point(tag, v16, v32, x, kw):
        """B9's fixed point with bf16 weights (a MAF's sample, an IAF's
        log_prob) by the route, which must be the bf16 degree kernel,
        against the bf16 plain version and the bf16 degree plain, whose
        schedule it shares; the bf16 fixed-point kernel, forced, against the
        bf16 plain version beside. Returns the route's (y, lad) and its
        largest error."""
        st, w16 = v16._static, v16._weights
        before = maf_flow_kernel.degree_launch_count
        y, lad = maf_flow_kernel.maf_flow_kernel_cuda(x, w16, st, packed=v16._packed, **kw)
        torch.cuda.synchronize()
        if maf_flow_kernel.degree_launch_count != before + 1:
            raise AssertionError(f"B9 {tag}: the call did not take the degree kernel")
        p16 = maf_flow_kernel.maf_flow_kernel_plain(x, w16, st, **kw)
        p32 = maf_flow_kernel.maf_flow_kernel_plain(x, v32._weights, st, **kw)
        q16 = maf_flow_kernel.maf_flow_kernel_plain(x, w16, st, schedule="degrees",
                                                    masks=v16._masks, **kw)
        f16 = maf_flow_kernel.maf_flow_kernel_cuda(x, w16, st, packed=v16._packed,
                                                   schedule="fixed_point", **kw)
        torch.cuda.synchronize()
        errs = [hold_bf16(f"{tag} out", y, p16[0], p32[0], BF16_OUT),
                hold_bf16(f"{tag} lad", lad, p16[1], p32[1], BF16_LAD),
                hold_bf16(f"{tag} out, against the degree plain", y, q16[0], p32[0], BF16_OUT),
                hold_bf16(f"{tag} lad, against the degree plain", lad, q16[1], p32[1],
                          BF16_LAD)]
        hold_bf16(f"{tag} out, fixed-point kernel", f16[0], p16[0], p32[0], BF16_OUT)
        hold_bf16(f"{tag} lad, fixed-point kernel", f16[1], p16[1], p32[1], BF16_LAD)
        return (y, lad), max(errs)

    def b9_bf16(model, ar_flow, context_features=None):
        v16, v32 = fuse_maf(ar_flow, dtype=BF16), fuse_maf(ar_flow)
        st = v16._static
        x = torch.randn(SERVE_BATCH, DA, generator=gen).to(dev)
        ctx = (None if context_features is None
               else torch.randn(SERVE_BATCH, context_features, generator=gen).to(dev))
        log(f"B9 in bf16 ({model}) at N={SERVE_BATCH}:")
        errs, out = [], {}
        for inverse in (False, True):
            kw = dict(inverse=inverse, context=ctx, num_blocks=v16._num_blocks,
                      transformer=v16._transformer, spline_kw=v16._spline_kw)
            tag = "inverse" if inverse else "forward"
            if not inverse:
                # the one pass on both routes: the bf16 wgmma kernel (the
                # route) and the bf16 SIMT kernel, forced
                _, one = b9_one_pass(tag, v16, x, kw, view32=v32)
                errs.append(one["wgmma"])
                out.update(wgmma_err=one["wgmma"], simt_err=one["simt"])
            else:
                errs.append(hold_bf16_fixed_point(tag, v16, v32, x, kw)[1])
            t = time_pair(
                lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: B023
                    x, v16._weights, st, packed=v16._packed, **kw),  # noqa: B023
                lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: B023
                    x, v32._weights, st, packed=v32._packed, **kw),  # noqa: B023
                lambda: maf_flow_kernel.maf_flow_kernel_plain(  # noqa: B023
                    x, v16._weights, st, **kw),  # noqa: B023
                "maf_degree_inverse" if inverse else "maf_flow_wgmma_kernel", iters=10)
            if not inverse:
                for key, v in (("simt_ms", v16), ("fp32_simt_ms", v32)):
                    t[key] = device_ms(
                        torch, lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: B023
                            x, v._weights, st, packed=v._packed, gemm="simt",  # noqa: B023
                            **kw), 10, kernel="maf_flow_kernel")  # noqa: B023
            if inverse:
                t["fixed_point_ms"] = device_ms(
                    torch, lambda: maf_flow_kernel.maf_flow_kernel_cuda(  # noqa: B023
                        x, v16._weights, st, packed=v16._packed,  # noqa: B023
                        schedule="fixed_point", **kw), 5, kernel="maf_flow_kernel")  # noqa: B023
            out.update(t if not inverse else {f"inverse_{k}": v for k, v in t.items()})
        nops = masked_ops(SERVE_BATCH, ar_flow) + (context_ops(SERVE_BATCH)
                                                   if context_features else 0)
        bound_ms, bound_by = bound_bf16(nops, v16._weights,
                                        SERVE_BATCH * (2 * DA + 1 + (context_features or 0)))
        dense = (dense_ops(SERVE_BATCH, v16._weights["wf"].shape[0] // LA)
                 + (context_ops(SERVE_BATCH) if context_features else 0))
        log(f"  time (forward / inverse): bf16 kernel {out['ms']:.4f} (wgmma; simt "
            f"{out['simt_ms']:.4f}) / {out['inverse_ms']:.4f} "
            f"ms (the bf16 fixed-point kernel {out['inverse_fixed_point_ms']:.4f} ms), fp32 "
            f"kernel {out['fp32_ms']:.4f} (wgmma; simt {out['fp32_simt_ms']:.4f}) / "
            f"{out['inverse_fp32_ms']:.4f} ms, bf16 "
            f"plain {out['plain_ms']:.4f} / {out['inverse_plain_ms']:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({bound_by}, {nops / 1e9:.2f} GFLOP the masks leave, at 989 "
            f"TFLOP/s): {100 * bound_ms / out['ms']:.2f}% of it forward on the wgmma route; "
            f"the dense count {dense / 1e9:.2f} GFLOP at that rate "
            f"{1e3 * dense / PEAK_BF16_FLOPS:.4f} ms")
        return dict(err=max(errs), bound_ms=bound_ms, bound_by=bound_by,
                    dense_ms=1e3 * dense / PEAK_BF16_FLOPS, **out)

    b9_bf16_stats = {"MAF": b9_bf16("MAF", maf), "NSF-AR": b9_bf16("NSF-AR", nsf_ar),
                     "conditional MAF": b9_bf16("conditional MAF", cmaf, C)}
    # the IAFs in bf16, on inputs from a generator of their own: the
    # sampling direction (one pass) on both routes, and the log_prob
    # direction (a fixed point on wrapped layers) on the degree kernel
    g_b = torch.Generator().manual_seed(31)
    for model, ar_flow, cf in (("IAF", iaf, None), ("conditional IAF", ciaf, C)):
        v16, v32 = fuse_maf(ar_flow, dtype=BF16), fuse_maf(ar_flow)
        x = torch.randn(SERVE_BATCH, DA, generator=g_b).to(dev)
        ctx = None if cf is None else torch.randn(SERVE_BATCH, cf, generator=g_b).to(dev)
        kw = dict(context=ctx, num_blocks=v16._num_blocks, transformer=v16._transformer,
                  spline_kw=v16._spline_kw)
        log(f"B9 in bf16 ({model}) at N={SERVE_BATCH}, its sampling direction:")
        b9_bf16_stats[model] = dict(zip(("err", "simt_err"), b9_one_pass(
            "inverse", v16, x, dict(inverse=True, **kw), view32=v32)[1].values()))
        log(f"B9 in bf16 ({model}) at N={SERVE_BATCH}, its log_prob direction:")
        b9_bf16_stats[model]["forward_err"] = hold_bf16_fixed_point(
            "forward", v16, v32, x, dict(inverse=False, **kw))[1]

    # B11 in bf16 on both routes, timed beside the fp32 kernels of each
    # route: at 4,096 on the shared generator's draw, at 65,536 and the
    # ragged N on draws of their own, and on the trained weights of phase 16
    b11_bf16_stats, b11_wgmma_bf16 = {}, {}
    for model, dist, cf in mog_models:
        v16, v32 = mademog_fused.fuse_mademog(dist, dtype=BF16), mademog_fused.fuse_mademog(dist)
        g_b = torch.Generator().manual_seed(LARGE_BATCH + (cf or 0))
        for n in (SERVE_BATCH, LARGE_BATCH, RAGGED):
            draw = gen if n == SERVE_BATCH else g_b
            x = (1.5 * torch.randn(n, DM, generator=draw)).to(dev)
            c = None if cf is None else torch.randn(n, cf, generator=draw).to(dev)
            log(f"B11 in bf16 ({model}) at N={n}, routes wgmma and simt:")
            errs = b11_routes(f"bf16 N={n}", v16, x, c, view32=v32)
            if n == RAGGED:
                b11_bf16_stats[model]["ragged_err"] = errs["simt"]
                b11_wgmma_bf16[model]["ragged_err"] = errs["wgmma"]
                continue
            iters = 10 if n == SERVE_BATCH else 3
            t16, t32 = b11_route_times(v16, x, c, iters), b11_route_times(v32, x, c, iters)
            plain_ms = device_ms(torch, lambda: mademog_fused.mademog_log_prob_plain(  # noqa: B023
                x, v16._weights, v16._static, c), 3 if n == SERVE_BATCH else 2)  # noqa: B023
            need, dense = mog_ops(dist, n)
            bound_ms, bound_by = bound_bf16(need, v16._weights, n * (DM + (cf or 0) + 1))
            log(f"  time: bf16 wgmma kernel {t16['wgmma'][0]:.4f} ms (fp32 {t32['wgmma'][0]:.4f}), "
                f"bf16 simt kernel {t16['simt'][0]:.4f} ms (fp32 {t32['simt'][0]:.4f}), bf16 "
                f"plain {plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({bound_by}, "
                f"{need / 1e9:.2f} GFLOP the masks leave, at 989 TFLOP/s): "
                f"{100 * bound_ms / t16['wgmma'][0]:.2f}% of it on the wgmma route; the dense "
                f"{dense / 1e9:.2f} GFLOP {1e3 * dense / PEAK_BF16_FLOPS:.4f} ms")
            if n == SERVE_BATCH:
                b11_bf16_stats[model] = dict(
                    err=errs["simt"], ms=t16["simt"][0], ms_source=t16["simt"][1],
                    fp32_ms=t32["simt"][0], plain_ms=plain_ms, bound_ms=bound_ms,
                    bound_by=bound_by)
                b11_wgmma_bf16[model] = dict(
                    err=errs["wgmma"], ms=t16["wgmma"][0], ms_source=t16["wgmma"][1],
                    simt_ms=t16["simt"][0], fp32_ms=t32["wgmma"][0], plain_ms=plain_ms,
                    bound_ms=bound_ms, bound_by=bound_by,
                    bound_basis="bf16 tensor cores, 989 TFLOP/s",
                    dense_ms=1e3 * dense / PEAK_BF16_FLOPS)
            else:
                b11_bf16_stats[model].update(ms_at_65536=t16["simt"][0],
                                             fp32_ms_at_65536=t32["simt"][0])
                b11_wgmma_bf16[model].update(ms_at_65536=t16["wgmma"][0],
                                             simt_ms_at_65536=t16["simt"][0],
                                             fp32_ms_at_65536=t32["wgmma"][0])
        trained, held, held_c = mog_trained[model]
        log(f"B11 in bf16 on the trained {model} at N={TRAIN_BATCH}:")
        t_errs = b11_routes("bf16 trained", mademog_fused.fuse_mademog(trained, dtype=BF16),
                            held, held_c, view32=mademog_fused.fuse_mademog(trained))
        b11_bf16_stats[model]["trained_err"] = t_errs["simt"]
        b11_wgmma_bf16[model]["trained_err"] = t_errs["wgmma"]

    # -- phase 32: serving in bf16 through CompiledFlow(dtype=torch.bfloat16) -------
    # the flagship, the MAF and the MoG-MADE at 4,096, bf16 requests: a log_prob
    # is one launch of the bf16 kernel (and none of the fp32 one), a sample one
    # more (B2, B9) or the sequential sampler (MoG-MADE); every count set to 0
    # just before each request and read just after
    bf16_launches = {}
    for model, dist, features, kid, sample_kernel in (
            ("NSF", flow, D, "B2_bf16", True), ("MAF", maf, DA, "B9_bf16", True),
            ("MoG-MADE", mog, DM, "B11_bf16", False), ("NSF-AR", nsf_ar, DA, "B9_bf16", True),
            ("IAF", iaf, DA, "B9_bf16", True)):
        server = CompiledFlow(dist, batch_size=SERVE_BATCH, features=features, dtype=BF16)
        if not server.is_fused:
            raise AssertionError(f"CompiledFlow(dtype=bfloat16) did not fuse the {model}")
        # the NSF-AR's and the IAF's inputs from a generator of their own
        draw = gen if model in ("NSF", "MAF", "MoG-MADE") else torch.Generator().manual_seed(
            len(model))
        x = torch.randn(SERVE_BATCH, features, generator=draw).to(dev).to(BF16)
        g = torch.Generator(device=dev).manual_seed(3)
        reset_counts()
        lp = server.log_prob(x)
        torch.cuda.synchronize()
        first = read_counts()
        reset_counts()
        s = server.sample(g)
        torch.cuda.synchronize()
        rest = read_counts()
        log(f"serving the {model} in bf16: launches a log_prob {first}, a sample {rest}")
        expect_counts(f"a bf16 {model} log_prob request", first, **{kid: 1},
                      **b2_route_counts(server), **b9_route_counts(server, "log_prob"),
                      **b11_route_counts(server))
        expect_counts(f"a bf16 {model} sample request", rest,
                      **({kid: 1} if sample_kernel else {}),
                      **b2_route_counts(server), **b9_route_counts(server, "sample"))
        bf16_launches.setdefault(kid, first[kid])
        if model == "MoG-MADE":
            bf16_launches["B11_wgmma_bf16"] = first["B11_wgmma_bf16"]
        if model == "MAF":
            bf16_launches["B9_degree"] = rest["B9_degree"]
            bf16_launches["B9_wgmma_bf16"] = first["B9_wgmma_bf16"]
            bf16_launches["B9_simt_bf16"] = first["B9_simt_bf16"] + rest["B9_simt_bf16"]
        if (tuple(lp.shape) != (SERVE_BATCH,) or lp.dtype != torch.float32
                or not torch.isfinite(lp).all() or tuple(s.shape) != (SERVE_BATCH, features)
                or not torch.isfinite(s).all()):
            raise AssertionError(f"bf16 {model}: bad output")
        with torch.no_grad():
            lp32 = CompiledFlow(dist, batch_size=SERVE_BATCH, features=features).log_prob(
                x.float())
        gap, price = max_err(lp, lp32), None
        v16 = server._fused
        if isinstance(v16, maf_fused.FusedMAF):
            # B9's served log_prob against its bf16 plain version on the same
            # request; bf16's own price is the bf16 plain version's distance
            # from the fp32 server
            kw = dict(inverse=False, num_blocks=v16._num_blocks,
                      transformer=v16._transformer, spline_kw=v16._spline_kw)
            v32 = fuse_maf(dist)
            y16, lad16 = maf_flow_kernel.maf_flow_kernel_plain(x.float(), v16._weights,
                                                               v16._static, **kw)
            y32, lad32 = maf_flow_kernel.maf_flow_kernel_plain(x.float(), v32._weights,
                                                               v32._static, **kw)
            p16, p32 = v16._log_base(y16) + lad16, v32._log_base(y32) + lad32
            hold_bf16("log_prob against the bf16 plain version", lp, p16, p32, BF16_LAD)
            price = max_err(p16, lp32)
        if isinstance(v16, mademog_fused.FusedMADEMoG):
            # B11's served log_prob against its bf16 plain version
            v32 = mademog_fused.fuse_mademog(dist)
            p16 = mademog_fused.mademog_log_prob_plain(x.float(), v16._weights, v16._static)
            p32 = mademog_fused.mademog_log_prob_plain(x.float(), v32._weights, v32._static)
            hold_bf16("log_prob against the bf16 plain version", lp, p16, p32, BF16_LAD)
            price = max_err(p16, lp32)
        # the 0.5 limit holds the kernel where bf16's price lies inside it;
        # where the bf16 plain version itself is further (an IAF's fixed
        # point), the hold against that plain version above is the check
        log(f"  log_prob against the fp32 server on the same bf16 inputs: max |delta| "
            f"{gap:.3e} (bf16's price" + ("" if price is None else
                                          f"; the bf16 plain version's {price:.3e}")
            + "; limit 0.5 where the bf16 plain version is within it)")
        if gap > 0.5 and not (price is not None and price > 0.5):
            raise AssertionError(f"bf16 {model}: log_prob is far from the fp32 server's")
        for endpoint, fn in (("log_prob", lambda: server.log_prob(x)),  # noqa: B023
                             ("sample", lambda: server.sample(  # noqa: B023
                                 torch.Generator(device=dev).manual_seed(4)))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / 10
            busy = device_ms(torch, fn, 10)
            log(f"  {endpoint}: {wall:.3f} ms a request of {SERVE_BATCH} (host clock), "
                f"device busy {busy:.3f} ms")
            serve_times[f"{model}, bf16, {endpoint}"] = dict(wall_ms=wall, busy_ms=busy)
    # B11's SIMT kernel serves in bf16 the widths the tensor cores do not
    # take: a log_prob request of the MoG-MADE at hidden 96 is one launch of it
    narrow = MixtureOfGaussiansMADE(**{**MOG, "hidden_features": 96}, **seeded(2)).eval()
    server = CompiledFlow(narrow, batch_size=SERVE_BATCH, features=DM, dtype=BF16)
    x = torch.randn(SERVE_BATCH, DM, generator=torch.Generator().manual_seed(96)).to(dev)
    reset_counts()
    lp = server.log_prob(x.to(BF16))
    torch.cuda.synchronize()
    first = read_counts()
    log(f"serving the MoG-MADE at hidden 96 in bf16: launches a log_prob {first}")
    expect_counts("a bf16 MoG-MADE log_prob request at hidden 96", first, B11_bf16=1,
                  B11_simt_bf16=1)
    bf16_launches["B11_simt_bf16"] = first["B11_simt_bf16"]
    v16, v32 = server._fused, mademog_fused.fuse_mademog(narrow)
    hold_bf16("log_prob against the bf16 plain version", lp,
              mademog_fused.mademog_log_prob_plain(x.to(BF16).float(), v16._weights,
                                                   v16._static),
              mademog_fused.mademog_log_prob_plain(x.to(BF16).float(), v32._weights,
                                                   v32._static), BF16_LAD)

    # -- phase 33: windows of steps, each replayed as a CUDA graph -----------------
    # make_scan_train_step on the eager route (B1, ten a step) and on the fused
    # trainers (B3; B9 + B10; B11 + B12): each window's first steps run eagerly
    # and the rest replay graphs captured once (the wrappers' counters move in
    # the eager steps and the captures, and not at all in a replay), held
    # against the same steps run one by one from identical state, and timed
    # beside that per-step loop.
    t_windows = time.perf_counter()
    from nflows_tpu_torch import make_scan_train_step
    from nflows_tpu_torch.core import _window

    adam_c = lambda params: torch.optim.Adam(params, lr=3e-4, capturable=True)  # noqa: E731
    K = _window.GRAPH_STEPS
    window_stats = {}          # (model, batch) -> wall / busy ms a step, window and loop

    def window_data(family, n, count, seed, cf):
        """``count`` seeded batches [count, n, D] of phase 7's (``family``
        "nsf") or phase 12's data, and their contexts where ``cf`` is given."""
        if family == "nsf":
            return torch.stack(batches(n, count, seed)), None
        pairs = ar_batches(n, count, seed, cf)
        return (torch.stack([x for x, _ in pairs]),
                None if cf is None else torch.stack([c for _, c in pairs]))

    def first_window_steps(count):
        """The steps a first window of ``count`` steps runs through the
        wrappers: its eager warm-up steps, then one capture of each graph,
        K steps and the remainder."""
        rest = count - _window.WARMUP_STEPS
        return _window.WARMUP_STEPS + min(rest, K) + (rest % K if rest > K else 0)

    def graph_kernel_records(what, fn, names, expected):
        """Check the kernel records by name in torch.profiler's trace of one
        window ``fn``, what its graph replays launched: each kernel must be
        there, ``expected`` times at most. A trace without them fails. The
        count is not held exactly: the trace of graph replays can miss a
        record (39 B9 of 40, beside 40 B10, in one run on an NVIDIA H100
        80GB HBM3, whose losses matched the per-step loop at every step)."""
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        records = {name: sum(e.count for e in prof.key_averages() if name in e.key)
                   for name in names}
        log(f"    kernel records in the trace of one window: {records} (launched {expected} "
            "each)")
        if not all(0 < count <= expected for count in records.values()):
            raise AssertionError(f"{what}: the trace of one window holds {records}, expected "
                                 f"each kernel, {expected} of each at most")

    # a window against the per-step loop from identical state, each at a limit
    # set from its own readings (an NVIDIA H100 80GB HBM3 at 700 W). The eager
    # window runs deterministic kernels: bit for bit. The MAF, MoG-MADE and
    # MADEMoG backwards add in an order that varies from run to run, and a
    # per-step loop stays within 3.8e-6 of its own twin over 40 steps: 1e-4.
    # B3 adds its gradient partial sums with atomics, 2.2e-8 apart from one
    # launch to the next. Under Adam, which divides each step by the root of
    # its second moment, that noise grows chaotically: a per-step loop drifts
    # up to 1.8e-2 from a twin of itself in 45 steps, and a window as far, up
    # to 7.5e-4 within 16 steps of a later state (tools/b3_window_drift.py
    # and earlier runs of this phase). So the B3 window is held under SGD with
    # momentum 0.9 (fused, so capturable), which carries the noise along
    # without amplifying it: 36 windows of 40 steps under SGD at 512 and
    # 4,096 stayed within 4.5e-5 of the loop (tools/b3_window_drift.py),
    # where one wrong step moves a loss by 1e-2 or more; limit 1e-3. The Adam window that is timed is held to its
    # first loss, bit for bit, and its drift is printed beside the twin's.
    EXACT, AR_LIMIT, B3_LIMIT = 0.0, 1e-4, 1e-3
    sgd_c = lambda params: torch.optim.SGD(params, lr=1e-3, momentum=0.9,  # noqa: E731
                                           fused=True)

    def hold_window(title, window_losses, loop_losses, limit, spread=None):
        gap = max_err(window_losses, loop_losses)
        first = bool(window_losses[0] == loop_losses[0])
        finite = bool(torch.isfinite(window_losses).all())
        ok = first and finite and (limit is None or gap <= limit)
        beside = "" if spread is None else f"; the per-step loop against a twin {spread:.3e}"
        held = "not held" if limit is None else f"limit {limit:g}"
        log(f"  {title}: window vs per-step loop, the first loss bit-equal: {first}, finite: "
            f"{finite}, all within {gap:.3e} ({held}); all bit-equal: "
            f"{torch.equal(window_losses, loop_losses)}{beside}")
        if not ok:
            raise AssertionError(f"{title}: the window disagrees with the per-step loop")

    def copy_state(dst, dst_opt, src, src_opt):
        """Write a trainer's weights and Adam moments into a twin's, in place."""
        with torch.no_grad():
            for k in src.weights:
                dst.weights[k].copy_(src.weights[k])
                for key, v in src_opt.state[src.weights[k]].items():
                    dst_opt.state[dst.weights[k]][key].copy_(v)

    def measure(fn, steps_n, reps=3):
        """Wall and busy ms a step of ``fn``, ``steps_n`` steps (a window
        captured before, or the same steps run one by one)."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0) / reps / steps_n
        busy = device_ms(torch, fn, 1) / steps_n
        return dict(wall_ms=wall, busy_ms=busy, idle=max(0.0, 1 - busy / wall))

    def report(title, key, window, loop):
        window_stats[key] = {**{f"window_{a}": b for a, b in window.items()},
                             **{f"loop_{a}": b for a, b in loop.items()}}
        log(f"  {title}: window {window['wall_ms']:.4f} ms a step (busy {window['busy_ms']:.4f}, "
            f"idle {100 * window['idle']:.0f}%), per-step loop {loop['wall_ms']:.4f} ms (busy "
            f"{loop['busy_ms']:.4f}, idle {100 * loop['idle']:.0f}%): "
            f"x{loop['wall_ms'] / window['wall_ms']:.2f}")

    FUSED_WINDOWS = (
        ("flagship NSF", "nsf", flow, None, sgd_c, B3_LIMIT, dict(B3=1), ("nsf_loss_grad",)),
        ("MAF", "ar", maf, None, adam_c, AR_LIMIT, dict(B9=1, B9_simt=1, B10=1),
         ("maf_flow_kernel", "maf_train_bwd")),
        ("MoG-MADE", "ar", mog, None, adam_c, AR_LIMIT, dict(B11=1, B11_simt=1, B12=1),
         ("mademog_log_prob", "mademog_train_bwd")),
        ("MADEMoG, context", "ar", mog_ctx, MOG_CONTEXT, adam_c, AR_LIMIT,
         dict(B11=1, B11_simt=1, B12=1), ("mademog_log_prob", "mademog_train_bwd")),
    )
    S_FUSED = 40
    log(f"windows of fused steps ({_window.WARMUP_STEPS} eager steps at a new shape, then "
        f"graphs of {K} steps; windows of {S_FUSED} steps):")
    for title, family, model, cf, hold_opt, limit, per_step, kernel_names in FUSED_WINDOWS:
        for n in (TRAIN_BATCH, SERVE_BATCH):
            data, ctx = window_data(family, n, S_FUSED, 31, cf)
            args = (data,) if cf is None else (data, ctx)

            def pair_of(make_opt):
                """A window over one trainer and the per-step loop over its twin."""
                tr = fused_trainer(copy.deepcopy(model), n)  # noqa: B023
                twin = fused_trainer(copy.deepcopy(model), n)  # noqa: B023
                tr_opt, twin_opt = tr.init_opt(make_opt), twin.init_opt(make_opt)
                step = twin.make_train_step(twin_opt)

                def loop():
                    return torch.stack([step(*(a[i] for a in args))  # noqa: B023
                                        for i in range(S_FUSED)])

                return tr, tr_opt, twin, twin_opt, tr.make_scan_train_step(tr_opt), loop

            def spread_of(make_opt):
                """Two more per-step loops from the initial state: how far the
                backward's order of sums alone carries them apart."""
                pair = [fused_trainer(copy.deepcopy(model), n) for _ in range(2)]  # noqa: B023
                pair = [t.make_train_step(t.init_opt(make_opt)) for t in pair]
                return max_err(*(torch.stack([f(*(z[i] for z in args))  # noqa: B023
                                              for i in range(S_FUSED)]) for f in pair))

            opt_name = "SGD with momentum" if hold_opt is sgd_c else "Adam"
            tr, tr_opt, twin, twin_opt, steps, loop = pair_of(hold_opt)
            reset_counts()
            losses = steps(*args)
            torch.cuda.synchronize()
            first = read_counts()
            spread = spread_of(hold_opt) if n == TRAIN_BATCH else None
            hold_window(f"{title} at batch {n} under {opt_name}, first window", losses, loop(),
                        limit, spread)
            copy_state(twin, twin_opt, tr, tr_opt)
            reset_counts()
            again = steps(*args)
            torch.cuda.synchronize()
            second = read_counts()
            hold_window(f"{title} at batch {n} under {opt_name}, second window", again, loop(),
                        limit)
            log(f"    launches by the wrappers in the first window (eager steps and captures) "
                f"{({a: b for a, b in first.items() if b})}, in the second (replays only) "
                f"{({a: b for a, b in second.items() if b})}; graphs held "
                f"{steps.window.captured}")
            expect_counts(f"the {title} window's eager steps and captures", first,
                          **{a: b * first_window_steps(S_FUSED) for a, b in per_step.items()})
            expect_counts(f"the {title} window's replays", second)
            if n == TRAIN_BATCH:
                graph_kernel_records(f"the {title} window", lambda: steps(*args),  # noqa: B023
                                     kernel_names, S_FUSED)
            if hold_opt is not adam_c:
                # the Adam window that is timed: its first loss bit for bit
                del steps, loop, tr, twin
                tr, tr_opt, twin, twin_opt, steps, loop = pair_of(adam_c)
                hold_window(f"{title} at batch {n} under Adam, first window", steps(*args),
                            loop(), None, spread_of(adam_c) if n == TRAIN_BATCH else None)
            report(f"batch {n} under Adam", (title, n),
                   measure(lambda: steps(*args), S_FUSED),  # noqa: B023
                   measure(loop, S_FUSED))
            del steps, loop, tr, twin

    # the eager flagship: ten B1 a step's forward
    S_EAGER = 16
    log(f"windows of eager flagship steps (windows of {S_EAGER} steps):")
    data, _ = window_data("nsf", TRAIN_BATCH, S_EAGER, 32, None)
    twin = create_train_state(copy.deepcopy(flow).train(), adam_c)
    eager_step = make_train_step()
    loop_losses = torch.stack([eager_step(twin, data[i % S_EAGER])[1]["loss"]
                               for i in range(2 * S_EAGER)])
    state = create_train_state(copy.deepcopy(flow).train(), adam_c)
    steps = make_scan_train_step()
    reset_counts()
    state, losses = steps(state, data)
    torch.cuda.synchronize()
    first = read_counts()
    reset_counts()
    state, again = steps(state, data)
    torch.cuda.synchronize()
    second = read_counts()
    log(f"eager flagship window at batch {TRAIN_BATCH}: launches by the wrappers in the first "
        f"window {({a: b for a, b in first.items() if b})}, in the second "
        f"{({a: b for a, b in second.items() if b})}; graphs held {steps.window.captured}")
    expect_counts("the eager window's eager steps and captures", first,
                  B1=L * first_window_steps(S_EAGER))
    expect_counts("the eager window's replays", second)
    hold_window("eager flagship, first window", losses, loop_losses[:S_EAGER], EXACT)
    hold_window("eager flagship, second window", again, loop_losses[S_EAGER:], EXACT)
    graph_kernel_records("the eager window", lambda: steps(state, data),
                         ("rq_spline_kernel",), L * S_EAGER)
    report(f"batch {TRAIN_BATCH}", ("eager flagship", TRAIN_BATCH),
           measure(lambda: steps(state, data), S_EAGER, reps=2),
           measure(lambda: [eager_step(twin, x) for x in data], S_EAGER, reps=1))
    del steps, state

    # dropout 0.1 under a CUDA generator: fresh masks every step, the same
    # losses for the same seed, finite and falling; a second window under a
    # new generator (a seed for each epoch) replaces the graph it replays
    dropped = NeuralSplineFlow(generator=torch.Generator().manual_seed(0),
                               rng=np.random.default_rng(0), device=dev,
                               dropout_probability=0.1, **FLAGSHIP)
    data, _ = window_data("nsf", TRAIN_BATCH, TRAIN_STEPS, 33, None)
    runs = {}
    for label, seed in (("seed 7", 7), ("seed 7 again", 7), ("seed 8", 8)):
        state = create_train_state(copy.deepcopy(dropped).train(), adam_c)
        steps = make_scan_train_step()
        runs[label] = steps(state, data, generator=torch.Generator(device=dev).manual_seed(seed))[1]
        if label == "seed 7":
            held = steps.window.captured
            runs["then seed 9"] = steps(state, data[:2 * K],
                                        generator=torch.Generator(device=dev).manual_seed(9))[1]
            recaptured = steps.window.captured
        del steps, state
    loop_state = create_train_state(copy.deepcopy(dropped).train(), adam_c)
    eager_step = make_train_step()
    g = torch.Generator(device=dev).manual_seed(7)
    loop_7 = torch.stack([eager_step(loop_state, x, generator=g)[1]["loss"] for x in data])
    g = torch.Generator(device=dev).manual_seed(9)
    loop_9 = torch.stack([eager_step(loop_state, x, generator=g)[1]["loss"] for x in data[:2 * K]])
    curve = runs["seed 7"].tolist()
    log(f"eager flagship window with dropout 0.1 under a CUDA generator ({TRAIN_STEPS} steps): "
        f"loss {curve[0]:.4f} -> {curve[-1]:.4f}; the same seed again "
        f"{max_err(runs['seed 7'], runs['seed 7 again']):.3e} apart, seed 8 "
        f"{max_err(runs['seed 7'], runs['seed 8']):.3e} apart, the per-step loop from seed 7 "
        f"{max_err(runs['seed 7'], loop_7):.3e} apart (limit: bit-equal, the replays draw the "
        f"masks the loop draws); a second window of {2 * K} steps under seed 9 "
        f"{max_err(runs['then seed 9'], loop_9):.3e} from the loop's, graphs held {held} "
        f"before it and {recaptured} after")
    if (not all(np.isfinite(curve)) or not np.mean(curve[-5:]) < np.mean(curve[:5])
            or not torch.equal(runs["seed 7"], runs["seed 7 again"])
            or not torch.equal(runs["seed 7"], loop_7)
            or not torch.equal(runs["then seed 9"], loop_9)
            or recaptured != held
            or torch.equal(runs["seed 7"], runs["seed 8"])):
        raise AssertionError(f"the dropout window: {runs}; graphs held {held}, {recaptured}")
    window_seconds = time.perf_counter() - t_windows
    log(f"windows: {json.dumps({f'{m}, {n}': v for (m, n), v in window_stats.items()})}")
    log(f"phase 33 (windows of steps) took {window_seconds:.1f} s")

    # -- phase 34: the transforms of queue A5 ------------------------------------
    # the learned CDFs on the identity half of the five spline couplings, the
    # quadratic, linear-rational, linear and cubic AR transforms, and UMNN: B1
    # and B5-B8 as a CDF calls them, B7 and B5 as the AR transforms call them;
    # the flows built from them served unfused through CompiledFlow, then
    # trained eagerly (see the module doc)
    t_a5 = time.perf_counter()
    import copy
    from contextlib import contextmanager

    from nflows_tpu_torch import Flow
    from nflows_tpu_torch.distributions import StandardNormal
    from nflows_tpu_torch.nn import nets
    from nflows_tpu_torch.transforms import (
        CompositeTransform,
        MaskedPiecewiseCubicAutoregressiveTransform,
        MaskedPiecewiseLinearAutoregressiveTransform,
        MaskedPiecewiseLinearRationalAutoregressiveTransform,
        MaskedPiecewiseQuadraticAutoregressiveTransform,
        MaskedUMNNAutoregressiveTransform,
        RandomPermutation,
        ReversePermutation,
        UMNNCouplingTransform,
    )
    from nflows_tpu_torch.utils.masks import create_alternating_binary_mask

    NB = FLAGSHIP["num_bins"]
    g34 = torch.Generator().manual_seed(34)
    # family -> (kernel id, wrapper module, wrapper name, plain version)
    spline_kernels = {"rq": ("B1", rq_spline, "rq_spline_cuda",
                             rq.unconstrained_rational_quadratic_spline_plain),
                      **{fam: (kid, module, wrapper.__name__, plain)
                         for fam, (kid, module, wrapper, plain, *_) in families.items()}}
    a5 = {kid: {} for kid, *_ in spline_kernels.values()}   # kid -> its row's phase-34 keys
    a5_stats = {}   # what the phase measured, by model

    @contextmanager
    def plain_splines():
        """Every spline wrapper of B1 and B5-B8 replaced by its plain version
        (same arguments), so that a flow on the card runs the plain splines."""
        saved = [(module, name, getattr(module, name))
                 for _, module, name, _ in spline_kernels.values()]
        try:
            for _, module, name, plain in spline_kernels.values():
                setattr(module, name, plain)
            yield
        finally:
            for module, name, fn in saved:
                setattr(module, name, fn)

    def hold_spline_path(kid, what, wrapper, plain, args):
        """``hold`` of a wrapper on ``args`` against its plain version, both
        directions, in phase 17's bands; the largest |kernel - plain|."""
        errs = []
        for inverse in (False, True):
            kw = dict(inverse=inverse, tail_bound=B)
            out, lad = wrapper(*args, **kw)
            p_out, p_lad = plain(*args, **kw)
            d_out, d_lad = plain(*[t.double() for t in args], **kw)
            torch.cuda.synchronize()
            if not (torch.isfinite(out).all() and torch.isfinite(lad).all()):
                raise AssertionError(f"{kid} {what} produced non-finite values")
            tag = f"{kid} {what}, {'inverse' if inverse else 'forward'}"
            errs += [hold(f"{tag} out", out, p_out, d_out, 1e-4),
                     hold(f"{tag} lad", lad, p_lad, d_lad, 1e-3)]
        return max(errs)

    # (a) the flagship's chain with the CDF on every identity half, each family
    cdf_flows = {fam: family_flow(fam, dev, seed=34, cdf=True) for fam in spline_kernels}
    with torch.no_grad():
        for fam, flow_c in cdf_flows.items():
            kid, module, wname, plain = spline_kernels[fam]
            cpl = flow_c.transform.transforms[1]
            cdf = cpl.unconditional_transform
            x = torch.randn(SERVE_BATCH, cpl.num_identity_features, generator=g34).to(dev)
            x.view(-1)[:4] = torch.tensor([B, -B, B + 0.5, -B - 0.5])
            # the rows the CDF hands its spline: one a feature, expanded over
            # the batch and made dense by the dispatch's .contiguous()
            args = [x] + [getattr(cdf, name).detach()[None].expand(
                SERVE_BATCH, *getattr(cdf, name).shape).contiguous() for name in cdf._PARAMS]
            log(f"{kid} ({fam}) as the learned CDF calls it, at {x.numel()} elements:")
            a5[kid]["cdf_err"] = hold_spline_path(kid, "CDF", getattr(module, wname), plain,
                                                  args)

    # (b) the AR chain at its width with each new spline transform
    def ar_flow(cls, seed, **kw):
        """5 x [ReversePermutation, ``cls`` with a 2-block residual MADE] at
        the AR family's widths (MAF), StandardNormal base, random weights
        from ``seed``."""
        g = torch.Generator().manual_seed(seed)
        chain = []
        for _ in range(MAF["num_layers"]):
            chain += [ReversePermutation(MAF["features"], device=dev),
                      cls(features=MAF["features"], hidden_features=MAF["hidden_features"],
                          num_blocks=MAF["num_blocks_per_layer"], generator=g, device=dev,
                          **kw)]
        return Flow(CompositeTransform(chain), StandardNormal([MAF["features"]])).to(dev).eval()

    linear_tails = dict(num_bins=NB, tails="linear", tail_bound=B)
    ar_flows = {"quadratic": (ar_flow(MaskedPiecewiseQuadraticAutoregressiveTransform, 34,
                                      **linear_tails), "B7"),
                "lrs": (ar_flow(MaskedPiecewiseLinearRationalAutoregressiveTransform, 35,
                                **linear_tails), "B5"),
                "linear": (ar_flow(MaskedPiecewiseLinearAutoregressiveTransform, 36,
                                   num_bins=NB), None),
                "cubic": (ar_flow(MaskedPiecewiseCubicAutoregressiveTransform, 37,
                                  num_bins=NB), None)}
    AR_D = MAF["features"]
    with torch.no_grad():
        for fam in ("quadratic", "lrs"):
            flow_a, kid = ar_flows[fam]
            _, module, wname, plain = spline_kernels[fam]
            perm, t = flow_a.transform.transforms[0], flow_a.transform.transforms[1]
            z, _ = perm(torch.randn(SERVE_BATCH, AR_D, generator=g34).to(dev))
            z.view(-1)[:4] = torch.tensor([B, -B, B + 0.5, -B - 0.5])
            p = t.autoregressive_net(z).reshape(SERVE_BATCH, AR_D, -1)
            s = t._hidden_scale()
            # as the transform splits and rescales them: quadratic its widths
            # only, linear-rational widths and heights
            parts = ([p[..., :NB] * s, p[..., NB:]] if fam == "quadratic" else
                     [p[..., :NB] * s, p[..., NB:2 * NB] * s, p[..., 3 * NB:],
                      p[..., 2 * NB:3 * NB]])
            log(f"{kid} ({fam}) as the AR transform calls it, at {z.numel()} elements:")
            a5[kid]["ar_err"] = hold_spline_path(
                kid, "AR", getattr(module, wname), plain,
                [t_.contiguous() for t_ in (z, *parts)])

    # (c) UMNN at the reference defaults
    UMNN = dict(integrand_net_layers=(50, 50, 50), cond_size=20, nb_steps=20)
    umnn_ar = ar_flow(MaskedUMNNAutoregressiveTransform, 38, **UMNN)
    g = torch.Generator().manual_seed(39)
    rng = np.random.default_rng(39)
    chain = []
    for i in range(FLAGSHIP["num_layers"]):
        chain += [RandomPermutation(D, rng=rng, device=dev),
                  UMNNCouplingTransform(
                      create_alternating_binary_mask(D, even=bool(i % 2)),
                      lambda n_in, n_out: nets.ResidualNet(
                          n_in, n_out, hidden_features=FLAGSHIP["hidden_features"],
                          num_blocks=FLAGSHIP["num_blocks_per_layer"], generator=g, device=dev),
                      apply_unconditional_transform=i == 0, generator=g, device=dev, **UMNN)]
    umnn_coupling = Flow(CompositeTransform(chain), StandardNormal([D])).to(dev).eval()

    def serve_a5(model, flow, features, lp_counts, sample_counts, x, num_samples=SERVE_BATCH,
                 refusal="", ties=0, consistent=True, calls=10):
        """Serve ``flow`` through CompiledFlow: unfused (``use_fused=True``
        raises, with ``refusal`` in its reason); count the launches of a
        log_prob request (``lp_counts``) and of a sample request of
        ``num_samples`` (``sample_counts``); hold the log_prob against the
        same flow on the plain splines by ``hold_relative`` (each sample's
        error against float64, relative to 1 + |log_prob|: the kernels'
        quantiles within the fp32 plain version's, or at most 1e-6, eight
        ulps of fp32, which no chain of 20 fp32 splines is held below: at
        initialisation the cubic chain puts both fp32 paths 1e-3 to 5e-3
        from float64, one steep bin amplifying the rounding of the layers
        before it, and B8's median there is twice the plain's, 8e-7); hold the
        log_prob of sample_and_log_prob against log_prob of its samples
        (``consistent``; up to ``ties`` samples on a linear spline's bin edge
        may miss, as in ``serve``, and are set aside in the log_prob hold);
        time both requests (wall over ``calls``,
        busy over a third of them)."""
        try:
            CompiledFlow(flow, batch_size=SERVE_BATCH, features=features, use_fused=True)
        except ValueError as e:
            if refusal not in str(e):
                raise AssertionError(f"{model}: use_fused=True refused for another reason: {e}")
        else:
            raise AssertionError(f"{model}: use_fused=True did not raise")
        server = CompiledFlow(flow, batch_size=SERVE_BATCH, features=features,
                              num_samples=num_samples)
        if server.is_fused:
            raise AssertionError(f"{model}: CompiledFlow fused a flow no kernel has a stage for")
        reset_counts()
        lp = server.log_prob(x)
        torch.cuda.synchronize()
        first = read_counts()
        reset_counts()
        s = server.sample(torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
        second = read_counts()
        log(f"serving {model} (unfused): launches a log_prob request "
            f"{ {k: v for k, v in first.items() if v} }, a sample request of {num_samples} "
            f"{ {k: v for k, v in second.items() if v} }")
        expect_counts(f"one {model} log_prob request", first, **lp_counts)
        expect_counts(f"one {model} sample request", second, **sample_counts)
        flow64 = copy.deepcopy(flow).double()
        with torch.no_grad(), plain_splines():
            p_lp = flow.log_prob(x)
            d_lp = flow64.log_prob(x.double())
        held = torch.arange(SERVE_BATCH, device=dev)
        if ties:
            # a piecewise-constant density (the linear spline's) jumps at
            # each knot: a sample whose path passes within rounding of one
            # takes the neighbouring bin's density on one path and not on
            # the other; the `ties` farthest from float64 are set aside
            far = (lp.double() - d_lp).abs()
            held = torch.argsort(far)[:-ties]
            log(f"  {ties} samples set aside as bin-edge ties, |kernel-f64| "
                + " ".join(f"{v:.3e}" for v in far.sort().values[-ties:].tolist()))
        hold_relative(torch, f"{model} log_prob against the flow on the plain splines", lp[held],
                      p_lp[held], d_lp[held], floor=1e-6)
        err = max_err(lp, p_lp)
        log(f"  |kernel-plain| {err:.3e}  |kernel-f64| {max_err(lp, d_lp):.3e}  "
            f"|plain-f64| {max_err(p_lp, d_lp):.3e}")
        s2, lp2 = server.sample_and_log_prob(torch.Generator(device=dev).manual_seed(2))
        for t_, shape in ((lp, (SERVE_BATCH,)), (s, (num_samples, features)),
                          (s2, (num_samples, features)), (lp2, (num_samples,))):
            if tuple(t_.shape) != shape or not torch.isfinite(t_).all():
                raise AssertionError(f"{model}: bad output {tuple(t_.shape)}")
        if consistent:
            # sample_and_log_prob's log_prob against log_prob of its samples,
            # on the same noise through the kernels, the plain splines and
            # the float64 plain splines
            def round_trip(f, z):
                xs, lad = f.transform.inverse(z)
                return (f.distribution.log_prob(z) - lad - f.log_prob(xs)).double().abs()

            z = torch.randn(num_samples, features, generator=g34).to(dev)
            with torch.no_grad():
                gaps = round_trip(flow, z)
                with plain_splines():
                    p_gaps = round_trip(flow, z) if lp_counts else gaps
                    d_gaps = round_trip(flow64, z.double())
            over = int((gaps > 5e-3).sum())
            # where a kernel runs, its gap may also be the plain fp32 path's
            # (twice it at most): a steep cubic bin amplifies the inverse's
            # rounding in both
            ok = over <= ties or (bool(lp_counts)
                                  and float(gaps.max()) <= 2.0 * float(p_gaps.max()))
            log(f"  sample_and_log_prob vs log_prob(samples): {float(gaps.max()):.3e}, on the "
                f"plain splines {float(p_gaps.max()):.3e}, in float64 {float(d_gaps.max()):.3e} "
                f"(limit 5e-3{f'; {over} bin-edge ties allowed up to {ties}' if ties else ''}"
                f"{', or twice the plain splines' if lp_counts else ''})  "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise AssertionError(f"{model}: sample_and_log_prob disagrees with log_prob")
        stats = dict(err=err, log_prob_launches={k: v for k, v in first.items() if v},
                     sample_launches={k: v for k, v in second.items() if v})
        for endpoint, fn in (("log_prob", lambda: server.log_prob(x)),
                             ("sample", lambda: server.sample(
                                 torch.Generator(device=dev).manual_seed(3)))):
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0) / calls
            busy = device_ms(torch, fn, max(1, calls // 3))
            log(f"  {endpoint}: {wall:.3f} ms a request of "
                f"{SERVE_BATCH if endpoint == 'log_prob' else num_samples} (host clock), "
                f"device busy {busy:.3f} ms")
            serve_times[f"{model}, unfused, {endpoint}"] = dict(wall_ms=wall, busy_ms=busy)
            stats[f"{endpoint}_wall_ms"], stats[f"{endpoint}_busy_ms"] = wall, busy
        a5_stats[model] = stats
        return first, second

    for fam, flow_c in cdf_flows.items():
        kid = spline_kernels[fam][0]
        first, second = serve_a5(
            f"{fam} couplings with the CDF", flow_c, D, {kid: 2 * L}, {kid: 2 * L},
            torch.randn(SERVE_BATCH, D, generator=g34).to(dev), refusal="unconditional",
            ties=SERVE_BATCH // 1000 if fam == "linear" else 0)
        a5[kid].update(cdf_launches=first[kid], cdf_sample_launches=second[kid])
    AR_L = MAF["num_layers"]
    for fam, (flow_a, kid) in ar_flows.items():
        bounded = kid is None
        x = (torch.rand(SERVE_BATCH, AR_D, generator=g34) if bounded
             else torch.randn(SERVE_BATCH, AR_D, generator=g34)).to(dev)
        # the bounded cubic's inverse, plain bisection on the host, takes
        # about 0.5 s a sample request: fewer timed requests
        first, second = serve_a5(
            f"{fam} AR" + (" (bounded)" if bounded else ""), flow_a, AR_D,
            {} if bounded else {kid: AR_L}, {} if bounded else {kid: AR_L * AR_D}, x,
            refusal="only affine / RQ-spline", consistent=not bounded,
            calls=3 if fam == "cubic" else 10)
        if not bounded:
            a5[kid].update(ar_launches=first[kid], ar_sample_launches=second[kid])
    # its sample request is about 1.2 s of host time (26 quadratures a
    # feature a layer): one timed request
    serve_a5("UMNN AR", umnn_ar, AR_D, {}, {},
             torch.randn(SERVE_BATCH, AR_D, generator=g34).to(dev), num_samples=512,
             refusal="only affine / RQ-spline", calls=1)
    serve_a5("UMNN couplings", umnn_coupling, D, {}, {},
             torch.randn(SERVE_BATCH, D, generator=g34).to(dev), num_samples=512,
             refusal="is not fused", calls=3)

    # (d) eager training: 5 Adam steps at 512
    def train_a5(model, flow, features, new, expected):
        """5 eager Adam steps at TRAIN_BATCH on a copy of ``flow``: a step's
        launches ``expected``, finite losses, and before them a finite
        gradient for every parameter, nonzero for each whose name holds
        ``new`` (None: no new parameters to check)."""
        flow_t = copy.deepcopy(flow).train()
        data = [torch.randn(TRAIN_BATCH, features, generator=g34).to(dev) for _ in range(5)]
        (-flow_t.log_prob(data[0]).mean()).backward()
        checked = 0
        for name, prm in flow_t.named_parameters():
            if prm.grad is None or not torch.isfinite(prm.grad).all():
                raise AssertionError(f"{model}: {name} has no finite gradient")
            if new is not None and new in name:
                checked += 1
                if not prm.grad.abs().max() > 0:
                    raise AssertionError(f"{model}: {name} has a zero gradient")
        if new is not None and not checked:
            raise AssertionError(f"{model}: no parameter named {new}")
        flow_t.zero_grad()
        state = create_train_state(flow_t, lambda prm: torch.optim.Adam(prm, lr=1e-3))
        step = make_train_step()
        losses, counts = [], None
        t0 = time.perf_counter()
        for i, batch in enumerate(data):
            reset_counts()
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
            if i == 0:
                counts = read_counts()
        wall = 1e3 * (time.perf_counter() - t0) / len(data)
        expect_counts(f"an eager {model} step", counts, **expected)
        log(f"training {model} eagerly: "
            + (f"{checked} new parameters with finite, nonzero gradients; "
               if new is not None else "")
            + f"launches a step {({k: v for k, v in counts.items() if v})}; losses "
            + " ".join(f"{v:.4f}" for v in losses) + f"; {wall:.1f} ms a step (host clock, "
            "the first included)")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"{model}: non-finite losses {losses}")
        a5_stats[f"{model}, training"] = dict(losses=losses, step_ms=wall,
                                              new_parameters=checked)

    train_a5("rq couplings with the CDF", cdf_flows["rq"], D, "unconditional_transform",
             {"B1": 2 * L})
    train_a5("quadratic AR", ar_flows["quadratic"][0], AR_D, None, {"B7": AR_L})
    train_a5("UMNN AR", umnn_ar, AR_D, "transformer.integrand_net", {})
    a5_seconds = time.perf_counter() - t_a5
    log(f"queue A5: {json.dumps(a5_stats)}")
    log(f"phase 34 (the transforms of queue A5) took {a5_seconds:.1f} s")

    # -- phase 35: the transforms of queue A6 ------------------------------------
    from types import SimpleNamespace

    a6_keys, _ = phase_a6(torch, dev, SimpleNamespace(reset=reset_counts, read=read_counts,
                                                      expect=expect_counts), serve_times)

    # -- phase 8: the kernels line ---------------------------------------------
    names = {"B1": "rq_spline", "B2": "nsf_flow_kernel", "B3": "nsf_loss_grad",
             "B4": "nsf_train_bwd", "B5": "lrs_spline", "B6": "linear_spline",
             "B7": "quadratic_spline", "B8": "cubic_spline", "B9": "maf_flow_kernel",
             "B10": "maf_train_bwd", "B11": "mademog_log_prob", "B12": "mademog_train_bwd"}

    def with_context(stats, ctx_stats, **more):
        """A row of a kernel that runs with and without a context: the
        unconditional model's numbers, the conditional twin's beside them
        (B2-B4: the conditional flagship, and the conditional affine chain
        under ``context_families``; B9, B10: the conditional MAF, and the
        conditional NSF-AR and IAF under ``context_families``; B11, B12: the
        MADEMoG)."""
        return {**stats, **{f"context_{k}": v for k, v in ctx_stats.items()}, **more}

    def at_both_batches(per_kind):
        """A training kernel's numbers for each family at the training batch,
        with its times at 2,048 and the serving batch beside them."""
        return {k: {**at_training_batch(v), f"ms_at_{SERVE_BATCH}": v[SERVE_BATCH]["ms"]}
                for k, v in per_kind.items()}

    def at_training_batch(per_n):
        """A training kernel's numbers at the training batch, with its time,
        cluster size and time at one block a tile at 2,048."""
        return {**per_n[TRAIN_BATCH], "ms_at_2048": per_n[2048]["ms"],
                "cluster_size_at_2048": per_n[2048]["cluster_size"],
                "ms_by_cluster_size_at_2048": per_n[2048]["ms_by_cluster_size"]}

    def cluster_at_batches(stats, model):
        """A cluster-layout training kernel's numbers (B10, B12) on ``model``
        at the training batch, with its time, cluster size and times by
        cluster size at 2,048 and the serving batch where it was run there."""
        out = dict(stats[(model, TRAIN_BATCH)])
        for n in (2048, SERVE_BATCH):
            if (model, n) in stats:
                out.update({f"ms_at_{n}": stats[(model, n)]["ms"],
                            f"cluster_size_at_{n}": stats[(model, n)]["cluster_size"],
                            f"ms_by_cluster_size_at_{n}":
                                stats[(model, n)]["ms_by_cluster_size"]})
        return out

    uncond, cond = (m for m, _, _ in mog_models)
    # the B9 rows count the launches of the kernels they time: the SIMT kernel
    # (a fused training step's forward; no bf16 request takes it) and the
    # degree kernel (a sampling request), split in simt_ and degree_launches;
    # a log_prob request's launch is the B9_wgmma rows'
    # B11's SIMT rows count their kernel's launches: a fused training step's
    # forward (fp32) and a bf16 request at hidden 96; a full-width log_prob
    # request's launch is the B11_wgmma rows'
    row_launches = {**launches, "B9": launches["B9_simt"] + launches["B9_degree"],
                    "B11": launches["B11_simt"]}
    bf16_row_launches = {**bf16_launches, "B9_bf16": (bf16_launches["B9_simt_bf16"]
                                                      + bf16_launches["B9_degree"]),
                         "B11_bf16": bf16_launches["B11_simt_bf16"]}
    rows = []
    for kid, stats, source, replaces, tpu in (
            ("B1", {**b1[SERVE_BATCH * 3], "ms_at_1048575": b1[(1 << 20) // 3 * 3]["ms"],
                    "inverse_ms_at_1048575": b1[(1 << 20) // 3 * 3]["inverse_ms"],
                    "layouts_err": b1["layouts_err"]},
             "nflows_tpu_torch/csrc/rq_spline.cu",
             "nflows_tpu/ops/pallas/rq_spline.py:39", "ops/pallas/rq_spline.py:_kernel"),
            ("B2", with_context({**b2[SERVE_BATCH], "families": b2_families,
                                 "ms_at_65536": b2[1 << 16]["ms"],
                                 "simt_ms_at_65536": b2[1 << 16]["simt_ms"],
                                 "simt_source": "nflows_tpu_torch/csrc/nsf_flow_kernel.cu"},
                                {**b2_ctx, "families": {"affine": b2_ctx_affine}},
                                context_launches=context_launches["B2"]),
             "nflows_tpu_torch/csrc/" + ("nsf_flow_wgmma.cu"
                                         if b2[SERVE_BATCH]["gemm_route"] == "wgmma"
                                         else "nsf_flow_kernel.cu"),
             "nflows_tpu/ops/pallas/nsf_flow_kernel.py:1095",
             "ops/pallas/nsf_flow_kernel.py:_kernel"),
            ("B3", with_context({**at_training_batch(b3),
                                 f"ms_at_{SERVE_BATCH}": b3[SERVE_BATCH]["ms"],
                                 f"ms_by_cluster_size_at_{SERVE_BATCH}":
                                     b3[SERVE_BATCH]["ms_by_cluster_size"],
                                 "cluster_rule_by_hidden": by_hidden,
                                 "families": at_both_batches(b3_families)},
                                {**at_training_batch(b3_ctx),
                                 f"ms_at_{SERVE_BATCH}": b3_ctx[SERVE_BATCH]["ms"],
                                 f"bound_ms_at_{SERVE_BATCH}": b3_ctx[SERVE_BATCH]["bound_ms"],
                                 "families": {"affine": at_training_batch(b3_ctx_affine)}},
                                context_launches=context_launches["B3"],
                                cluster_source="nflows_tpu_torch/csrc/nsf_train_cluster.cu"),
             "nflows_tpu_torch/csrc/nsf_train.cu",
             "nflows_tpu/ops/pallas/nsf_train.py:295",
             "ops/pallas/nsf_train.py:_loss_grad_kernel"),
            ("B4", with_context({**at_training_batch(b4),
                                 f"ms_at_{SERVE_BATCH}": b4[SERVE_BATCH]["ms"],
                                 f"ms_by_cluster_size_at_{SERVE_BATCH}":
                                     b4[SERVE_BATCH]["ms_by_cluster_size"],
                                 "held_tie": tie,
                                 "families": at_both_batches(b4_families)},
                                {**at_training_batch(b4_ctx),
                                 "held_tie": ctx_tie,
                                 f"ms_at_{SERVE_BATCH}": b4_ctx[SERVE_BATCH]["ms"],
                                 f"bound_ms_at_{SERVE_BATCH}": b4_ctx[SERVE_BATCH]["bound_ms"],
                                 "families": {"affine": at_training_batch(b4_ctx_affine)}},
                                context_launches=context_launches["B4"],
                                cluster_source="nflows_tpu_torch/csrc/nsf_train_cluster.cu"),
             "nflows_tpu_torch/csrc/nsf_train.cu",
             "nflows_tpu/ops/pallas/nsf_train.py:163",
             "ops/pallas/nsf_train.py:_bwd_kernel"),
            ("B9", with_context(b9["MAF"], b9_ctx["conditional MAF"],
                                simt_launches=launches["B9_simt"],
                                context_launches=(context_launches["B9_simt"]
                                                  + context_launches["B9_degree"]),
                                context_simt_launches=context_launches["B9_simt"],
                                context_degree_launches=context_launches["B9_degree"],
                                context_families={"NSF-AR": b9_ctx["conditional NSF-AR"]},
                                families={"NSF-AR": b9["NSF-AR"]},
                                degree_launches=launches["B9_degree"],
                                degree_source="nflows_tpu_torch/csrc/maf_degree_inverse.cu"),
             "nflows_tpu_torch/csrc/maf_flow_kernel.cu",
             "nflows_tpu/ops/pallas/maf_flow_kernel.py:99",
             "ops/pallas/maf_flow_kernel.py:_kernel"),
            ("B10", with_context(
                {**cluster_at_batches(b10, "MAF"),
                 **{f"inverse_{k}": v
                    for k, v in cluster_at_batches(b10_inv, "IAF").items()},
                 "inverse_launches": vi_launches,
                 "families": {"NSF-AR": cluster_at_batches(b10, "NSF-AR")}},
                cluster_at_batches(b10_ctx, "conditional MAF"),
                context_launches=context_launches["B10"],
                context_families={"NSF-AR": cluster_at_batches(b10_ctx, "conditional NSF-AR"),
                                  "IAF": cluster_at_batches(b10_inv, "conditional IAF")},
                cluster_source="nflows_tpu_torch/csrc/maf_train_cluster.cu",
                held_tie={f"{m} at N={n}, cluster size {c}": t
                          for (m, n, c), t in b10_tie.items()},
                cluster_launches_by_phase=b10_phase_launches,
                cluster_steps=b10_step_clusters),
             "nflows_tpu_torch/csrc/maf_train.cu",
             "nflows_tpu/ops/pallas/maf_train.py:161",
             "ops/pallas/maf_train.py:_bwd_kernel"),
            ("B11", with_context(b11[(uncond, SERVE_BATCH)], b11[(cond, SERVE_BATCH)],
                                 ms_at_65536=b11[(uncond, LARGE_BATCH)]["ms"],
                                 context_ms_at_65536=b11[(cond, LARGE_BATCH)]["ms"]),
             "nflows_tpu_torch/csrc/mademog_fused.cu",
             "nflows_tpu/ops/pallas/mademog_fused.py:169",
             "ops/pallas/mademog_fused.py:_kernel"),
            ("B12", with_context(cluster_at_batches(b12, uncond), cluster_at_batches(b12, cond),
                                 cluster_source="nflows_tpu_torch/csrc/mademog_train_cluster.cu",
                                 cluster_launches_by_phase=b12_phase_launches,
                                 cluster_steps=b12_step_clusters),
             "nflows_tpu_torch/csrc/mademog_train.cu",
             "nflows_tpu/ops/pallas/mademog_train.py:88",
             "ops/pallas/mademog_train.py:_bwd_kernel"),
            *((kid, {**family_stats[kid][SERVE_BATCH * 3],
                     f"ms_at_{big}": family_stats[kid][big]["ms"],
                     f"inverse_ms_at_{big}": family_stats[kid][big]["inverse_ms"],
                     **({"layouts_err": family_stats[kid]["layouts_err"]}
                        if "layouts_err" in family_stats[kid] else {})},
               f"nflows_tpu_torch/csrc/{stem}.cu", f"nflows_tpu/ops/pallas/{stem}.py:{line}",
               f"ops/pallas/{stem}.py:_kernel")
              for kid, stem, line, big in (
                  ("B5", "lrs_spline", 31, (1 << 20) // 3 * 3),
                  ("B6", "linear_spline", 28, (1 << 20) // 3 * 3),
                  ("B7", "quadratic_spline", 29, (1 << 20) // 3 * 3),
                  ("B8", "cubic_spline", 35, (1 << 20) // 3 * 3)))):
        rows.append({
            "name": names[kid], "id": kid,
            "route": "cuda", "source": source, "replaces": replaces, "tpu": tpu,
            "launches": row_launches[kid], "max_abs_err": stats["err"], "max_err": stats["err"],
            "ms": stats["ms"], "kernel_ms": stats["ms"], "ms_source": stats["ms_source"],
            "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"],
            "library_ms": None,
            **{k: v for k, v in stats.items()
               if k.startswith(("inverse_", "forward_", "schedule_", "context_", "ms_at_",
                                "families", "cluster_", "ms_by_", "active_", "held_",
                                "degree_", "gemm_route", "simt_", "bound_basis",
                                "cuda_core_", "launch_floor_", "layouts_"))},
        })
    for kid, stats, more, stem, replaces, tpu in (
            ("B2", b2_bf16_stats[SERVE_BATCH],
             dict(ms_at_65536=b2_bf16_stats[1 << 16]["ms"],
                  fp32_ms_at_65536=b2_bf16_stats[1 << 16]["fp32_ms"],
                  simt_ms_at_65536=b2_bf16_stats[1 << 16].get("simt_ms"),
                  simt_source="nflows_tpu_torch/csrc/nsf_flow_kernel_bf16.cu",
                  families={"affine": b2_bf16_affine},
                  **{f"context_{k}": v for k, v in b2_bf16_ctx.items()}),
             "nsf_flow_wgmma_bf16" if b2_bf16_stats[SERVE_BATCH]["gemm_route"] == "wgmma"
             else "nsf_flow_kernel_bf16", "nflows_tpu/ops/pallas/nsf_flow_kernel.py:1095",
             "ops/pallas/nsf_flow_kernel.py:_kernel"),
            ("B9", {**b9_bf16_stats["MAF"], "err": b9_bf16_stats["MAF"]["simt_err"],
                    "ms": b9_bf16_stats["MAF"]["simt_ms"],
                    "wgmma_ms": b9_bf16_stats["MAF"]["ms"]},
             dict(families={"NSF-AR": b9_bf16_stats["NSF-AR"]},
                  simt_launches=bf16_launches["B9_simt_bf16"],
                  degree_launches=bf16_launches["B9_degree"],
                  degree_source="nflows_tpu_torch/csrc/maf_degree_inverse_bf16.cu",
                  **{f"context_{k}": v for k, v in b9_bf16_stats["conditional MAF"].items()}),
             "maf_flow_kernel_bf16", "nflows_tpu/ops/pallas/maf_flow_kernel.py:99",
             "ops/pallas/maf_flow_kernel.py:_kernel"),
            ("B11", b11_bf16_stats["MoG-MADE"],
             {f"context_{k}": v for k, v in b11_bf16_stats["MADEMoG, context"].items()},
             "mademog_fused", "nflows_tpu/ops/pallas/mademog_fused.py:169",
             "ops/pallas/mademog_fused.py:_kernel")):
        rows.append({
            "name": f"{names[kid]}_bf16", "id": f"{kid}_bf16", "dtype": "bfloat16",
            "route": "cuda", "source": f"nflows_tpu_torch/csrc/{stem}.cu", "replaces": replaces,
            "tpu": tpu, "launches": bf16_row_launches[f"{kid}_bf16"],
            "max_abs_err": stats["err"],
            "max_err": stats["err"], "ms": stats["ms"], "kernel_ms": stats["ms"],
            "ms_source": stats["ms_source"], "plain_ms": stats["plain_ms"],
            "bound_ms": stats["bound_ms"], "bound_by": stats["bound_by"], "library_ms": None,
            **{k: v for k, v in stats.items()
               if k.startswith(("inverse_", "fp32_", "simt_", "gemm_route", "bound_basis",
                                "ms_at_", "ragged_", "trained_"))},
            **more,
        })
    # B9's one pass on the tensor cores, both weight types (csrc/maf_flow_wgmma.cuh)
    w9, w16 = b9_wgmma["MAF"], b9_bf16_stats["MAF"]
    for kid, stem, stats, n_launch, more in (
            ("B9_wgmma", "maf_flow_wgmma", w9, launches["B9_wgmma"], dict(
                families={m: b9_wgmma[m] for m in ("NSF-AR", "IAF")},
                **{f"context_{k}": v for k, v in b9_wgmma["conditional MAF"].items()},
                context_families={m: b9_wgmma[m]
                                  for m in ("conditional NSF-AR", "conditional IAF")},
                context_launches=context_launches["B9_wgmma"],
                untamed_err=b9_untamed, trainer_weights=b9_trainer_weights)),
            ("B9_wgmma_bf16", "maf_flow_wgmma_bf16",
             {**w16, "err": w16["wgmma_err"]}, bf16_launches["B9_wgmma_bf16"], dict(
                 dtype="bfloat16",
                 families={m: b9_bf16_stats[m] for m in ("NSF-AR", "IAF", "conditional IAF")},
                 **{f"context_{k}": v for k, v in b9_bf16_stats["conditional MAF"].items()}))):
        rows.append({
            "name": stem, "id": kid, "route": "cuda",
            "source": f"nflows_tpu_torch/csrc/{stem}.cu",
            "replaces": "nflows_tpu/ops/pallas/maf_flow_kernel.py:99",
            "tpu": "ops/pallas/maf_flow_kernel.py:_kernel", "launches": n_launch,
            "max_abs_err": stats["err"], "max_err": stats["err"], "ms": stats["ms"],
            "kernel_ms": stats["ms"], "ms_source": stats["ms_source"],
            "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
            "bound_by": stats["bound_by"], "library_ms": None,
            **{k: v for k, v in stats.items()
               if k.startswith(("simt_", "fp32_", "dense_", "bound_basis", "ms_at_"))},
            **more,
        })
    # B11 on the tensor cores, both weight types (csrc/mademog_wgmma.cuh)
    w11, w11c = b11_wgmma[(uncond, SERVE_BATCH)], b11_wgmma[(cond, SERVE_BATCH)]
    serving = {k: v for k, v in serve_times.items() if k.startswith((uncond, cond))}
    for kid, stem, stats, n_launch, more in (
            ("B11_wgmma", "mademog_wgmma", w11, launches["B11_wgmma"], dict(
                ms_at_65536=b11_wgmma[(uncond, LARGE_BATCH)]["ms"],
                simt_ms_at_65536=b11_wgmma[(uncond, LARGE_BATCH)]["simt_ms"],
                ragged_err=b11_wgmma[(uncond, RAGGED)]["err"],
                **{f"context_{k}": v for k, v in w11c.items()},
                context_ms_at_65536=b11_wgmma[(cond, LARGE_BATCH)]["ms"],
                context_simt_ms_at_65536=b11_wgmma[(cond, LARGE_BATCH)]["simt_ms"],
                context_ragged_err=b11_wgmma[(cond, RAGGED)]["err"],
                context_launches=context_launches["B11_wgmma"],
                trainer_weights=b11_trainer_weights, serving=serving)),
            ("B11_wgmma_bf16", "mademog_wgmma_bf16", b11_wgmma_bf16[uncond],
             bf16_launches["B11_wgmma_bf16"], dict(
                 dtype="bfloat16",
                 **{f"context_{k}": v for k, v in b11_wgmma_bf16[cond].items()},
                 serving={k: v for k, v in serve_times.items()
                          if k.startswith(f"{uncond}, bf16")}))):
        rows.append({
            "name": stem, "id": kid, "route": "cuda",
            "source": f"nflows_tpu_torch/csrc/{stem}.cu",
            "replaces": "nflows_tpu/ops/pallas/mademog_fused.py:169",
            "tpu": "ops/pallas/mademog_fused.py:_kernel", "launches": n_launch,
            "max_abs_err": stats["err"], "max_err": stats["err"], "ms": stats["ms"],
            "kernel_ms": stats["ms"], "ms_source": stats["ms_source"],
            "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
            "bound_by": stats["bound_by"], "library_ms": None,
            **{k: v for k, v in stats.items()
               if k.startswith(("simt_", "fp32_", "dense_", "bound_basis", "ms_at_", "ragged_",
                                "trained_"))},
            **more,
        })
    for row in rows:
        # phase 34's paths: the learned CDF's and the AR transforms' launches
        row.update(a5.get(row["id"], {}))
        # phase 35's: B1 as the NSF-AR with LU layers and the batch-normed
        # flagship call it
        if row["id"] == "B1":
            row.update(a6_keys)
    rows.sort(key=lambda row: (int(row["id"].split("_")[0][1:]), row["id"]))
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
