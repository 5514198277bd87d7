"""The forward recurrence's launch rule of the BLSTM kernels (``lstm_cell.
recur_plan``) and the weight layout of its resident launch, on the CPU.

The rule picks, from (B, T, H), how K1-stash, K1-chunk and K3's replay
run their forward recurrences on the card: streaming Wh from device
memory on clusters of 2 CTAs (the short §V launches and 8-row tiles), or
with Wh resident in the shared memory of clusters of 16 CTAs (the long
launches of the T = 2000 slice), in as many waves as the card holds such
clusters at once (``recur_waves`` of the queried count).  Where a
resident launch is called for and H does not split into 16 slices that
fit a CTA it raises: nothing falls back.  The reverse recurrence (K2,
K3) always streams; K1 inference and the fused stack K4 never consult
the rule.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import lstm_cell as LC  # noqa: E402


# (L, B, T, H): the forward launches of the port's main paths
TRAIN_LONG_K1_CHUNK = (16, 2, 2000, 512)     # K1-chunk, and K1-stash
TRAIN_LONG_K3 = (16, 2, 256, 512)            # each K = 256 replay of K3
SECTION_V = (16, 16, 21, 512)                # the paper's training step
T300_K1_CHUNK = (4, 2, 300, 512)             # chip_smoke's k3 phase
T300_K3 = (4, 2, 64, 512)                    # its K = 64 replays
EVALUATE = (1, 8, 256, 512)                  # evaluate's batch of 8

RESIDENT = LC.RecurPlan("resident", 2, 16)
STREAM_8 = LC.RecurPlan("stream", 8, 2)


@pytest.mark.parametrize("shape,want", [
    (TRAIN_LONG_K1_CHUNK, RESIDENT), (TRAIN_LONG_K3, RESIDENT),
    (SECTION_V, STREAM_8), (T300_K1_CHUNK, RESIDENT), (T300_K3, RESIDENT),
    (EVALUATE, STREAM_8),
])
def test_plan_at_the_main_path_shapes(shape, want):
    """The 2-row tiles of the train-long slice and of chip_smoke's k3
    phase run resident; the §V step's 8-row tiles stream on clusters of
    2.  Evaluate runs K4, which does not consult the rule:
    its shape would stream."""
    L, B, T, H = shape
    assert LC.recur_plan(B, T, H) == want


@pytest.mark.parametrize("active,waves", [(7, 5), (6, 6), (32, 1)])
@pytest.mark.parametrize("shape", [TRAIN_LONG_K1_CHUNK, TRAIN_LONG_K3])
def test_train_long_waves(shape, active, waves):
    """32 recurrences (16 learners x 2 directions, one 2-row tile each)
    of 16 CTAs: 5 waves where the card holds 7 such clusters at once (what
    cudaOccupancyMaxActiveClusters reports on the 132-SM H100), 6 where
    it holds 6, one where it holds them all."""
    L, B, T, H = shape
    assert LC.recur_waves(LC.recur_plan(B, T, H), L, B, active) == waves


@pytest.mark.parametrize("active,waves", [(7, 2), (6, 2), (8, 1)])
def test_t300_waves(active, waves):
    """8 recurrences of chip_smoke's 4 learners; the card test's 16
    learners make 32, two waves or more."""
    L, B, T, H = T300_K1_CHUNK
    plan = LC.recur_plan(B, T, H)
    assert LC.recur_waves(plan, L, B, active) == waves
    assert LC.recur_waves(plan, 16, B, active) >= 2


@pytest.mark.parametrize("T", [1, LC.RESIDENT_MIN_STEPS - 1])
def test_short_launches_stream(T):
    plan = LC.recur_plan(2, T, 512)
    assert plan.path == "stream" and plan.cluster == LC.cluster_size


@pytest.mark.parametrize("B", [5, 16, 64])
def test_eight_row_tiles_stream_at_any_length(B):
    """Tiles above RESIDENT_MAX_ROWS rows stream, however long."""
    assert LC.recur_plan(B, 2000, 512) == STREAM_8


@pytest.mark.parametrize("H", [520, 704, 1024, 96])
def test_resident_raises_where_h_does_not_split(H):
    """No fallback: H not a multiple of 64, or slices too large for one
    CTA's shared memory, raise where the rule calls for residence."""
    with pytest.raises(ValueError, match="resident on clusters of 16"):
        LC.recur_plan(2, 2000, H)


@pytest.mark.parametrize("H", [96, 200])
def test_short_launches_do_not_need_a_resident_split(H):
    """Widths the streaming launch takes run at short T whatever the
    resident split would need."""
    assert LC.recur_plan(2, LC.RESIDENT_MIN_STEPS - 1, H).path == "stream"
    with pytest.raises(ValueError, match="resident"):
        LC.recur_plan(2, LC.RESIDENT_MIN_STEPS, H)


@pytest.mark.parametrize("H,BB,want", [
    (512, 1, 135232), (512, 2, 139328), (512, 4, 147520), (512, 8, 163904),
])
def test_resident_shared_memory(H, BB, want):
    """The 128 KB slice of Wh at H = 512, then h double-buffered in f32,
    two barriers and the lengths: every tile size fits 227 KB."""
    got = LC.resident_smem(H, BB)
    assert got == want and got <= LC.SMEM_LIMIT


@pytest.mark.parametrize("B,T,want", [(2, 2000, (2, 2, 1)),
                                      (16, 21, (8, 2, 0))])
def test_c_arguments_keep_the_streaming_cluster(B, T, want):
    """(block_b, cluster, resident) of the C interface: a resident plan
    still passes the streaming cluster of 2, on which the reverse
    recurrence of K3 runs."""
    assert LC._plan_args(LC.recur_plan(B, T, 512), 512) == want


@pytest.mark.parametrize("L,H", [(2, 128), (1, 512)])
def test_resident_forward_layout(L, H):
    """[l, c, k2, jj, q, e] = Wh[2·k2 + e, q·H + c·U + jj]: CTA c's words
    hold the weights of inputs 2·k2 and 2·k2 + 1 of one (unit, gate)."""
    g = torch.Generator().manual_seed(H)
    wh = torch.randn(L, H, 4 * H, generator=g).to(torch.bfloat16)
    got = LC._res_fwd_layout(wh)
    C, U = 16, H // 16
    assert got.shape == (L, C, H // 2, U, 4, 2) and got.is_contiguous()
    l, c, k2, jj, q, e = torch.meshgrid(
        *(torch.arange(n) for n in got.shape), indexing="ij")
    want = wh[l, 2 * k2 + e, q * H + c * U + jj]
    assert torch.equal(got, want)
