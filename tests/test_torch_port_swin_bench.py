"""The benchmark's SwinUNETR and four-GPU cells on the CPU: their manifest
entries and files, the readers of their per-layer metrics on made-up
traces, the range reader's launch correlation, the DDP driver's global
batch, and the SwinUNETR cell's driver end to end at a tiny size."""
import copy
import json
import types

import pytest
import torch

from portbench import ranges, swin_flops
from portbench.drivers import infer_swin, train_ddp
from portbench.manifest import Cell, load
from portbench.run import Context, result_line
from segmentation3d_tpu_torch.utils import tracing

NEW_CELLS = ("swin_unetr.infer_bf16_ov50", "vnet.train_ddp4")


@pytest.mark.parametrize("name", NEW_CELLS)
def test_new_cells_load_with_their_files_and_readers(name):
    cell = Cell(load(), name)
    assert [m["name"] for m in cell.end_to_end][-1] == "setup_s"
    assert len(cell.end_to_end) == 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(cell.reader(m["name"]))
    assert set(cell.limits["compared"]) <= set(cell.limits)
    assert cell.entry["chips"] == (4 if name == "vnet.train_ddp4" else 1)


def _event(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_range_reader_follows_each_launch_to_its_kernel(tmp_path):
    """Kernels count for a range when their launch lies inside one of its
    intervals on the same thread, however late they run; nested ranges
    both count them."""
    events = [
        _event("user_annotation", "swin.encoder", 0, 100),
        _event("user_annotation", "swin.window_attention", 10, 20),
        _event("user_annotation", "swin.window_attention", 50, 20),
        _event("cuda_runtime", "cudaLaunchKernel", 15, 1, corr=1),    # attention
        _event("cuda_driver", "cuLaunchKernel", 55, 1, corr=2),       # attention
        _event("cuda_runtime", "cudaLaunchKernel", 40, 1, corr=3),    # encoder only
        _event("cuda_runtime", "cudaLaunchKernel", 150, 1, corr=4),   # outside
        _event("cuda_runtime", "cudaLaunchKernel", 16, 1, tid=2, corr=5),  # other thread
        _event("kernel", "fmha", 500, 7, tid=7, corr=1),
        _event("kernel", "fmha", 600, 5, tid=7, corr=2),
        _event("kernel", "gemm", 700, 11, tid=7, corr=3),
        _event("kernel", "gemm", 800, 13, tid=7, corr=4),
        _event("kernel", "gemm", 900, 17, tid=7, corr=5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = ranges.kernel_seconds(str(path), ("swin.encoder", "swin.window_attention", "none"))
    assert got == pytest.approx({"swin.encoder": 23e-6, "swin.window_attention": 12e-6,
                                 "none": 0.0})


NET = {"feature_size": 48, "in_channels": 1, "num_classes": 14, "depths": [2, 2, 2, 2],
       "num_heads": [3, 6, 12, 24], "window_size": 7}


def _swin_run(counter, kernel_s=1e-3, boxes=(9,)):
    calls = swin_flops.attention_calls(NET, (96, 96, 96))
    return {"range_kernel_s": {"swin.window_attention": kernel_s, "swin.encoder": 2e-3},
            "program_spans": tracing.Taken([], {"swin.windows": counter}, 0),
            "batch": 4, "boxes": list(boxes), "attention_calls": calls, "head_dim": 16,
            "peak": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
            "trace": types.SimpleNamespace(busy_s=0.01)}


def test_attention_roofline_reads_only_when_the_window_counts_agree():
    read = Cell(load(), NEW_CELLS[0]).reader("roofline.window_attention")
    windows = 9 * swin_flops.windows_per_box(NET, (96, 96, 96))
    assert windows == 9 * 832
    least = 0.0
    for b in (4, 4, 1):
        for call in swin_flops.attention_calls(NET, (96, 96, 96)):
            ops, nbytes = swin_flops.attention_work(call, b, 16)
            least += max(ops / 989e12, nbytes / 3.35e12)
    assert read(_swin_run(windows)) == pytest.approx(100.0 * least / 1e-3)
    assert read(_swin_run(windows - 1)) is None
    assert read(_swin_run(windows, kernel_s=0.0)) is None
    assert read({"program_spans": None}) is None
    # one shifted stage-1 call of 4 boxes reads its 0.24 GB mask once
    ops, nbytes = swin_flops.attention_work((0, 1, 343, 3, 343, True), 4, 16)
    assert ops == 4 * 4 * 343 * 3 * 343 ** 2 * 16
    assert nbytes == 2 * (4 * 4 * 343 * 3 * 343 * 16 + 343 * 3 * 343 ** 2)


def test_encoder_and_collective_shares():
    swin, ddp = Cell(load(), NEW_CELLS[0]), Cell(load(), NEW_CELLS[1])
    assert swin.reader("swin.encoder_share")(_swin_run(0)) == pytest.approx(20.0)
    assert swin.reader("swin.encoder_share")({"trace": None}) is None
    tr = types.SimpleNamespace(busy_s=2.0, kernels=lambda match: [
        s for n, s in (("ncclDevKernel_AllReduce_Sum_f32", 0.3), ("gemm", 1.0),
                       ("ncclKernel_Broadcast", 0.1)) if match(n)])
    assert ddp.reader("train.collective_share")({"trace": tr}) == pytest.approx(20.0)
    assert ddp.reader("train.collective_share")({}) is None


def test_global_capture_puts_the_ranks_rows_in_rank_order():
    ranks = [{"batches": [(torch.full((2, 1), float(r)), torch.full((2,), r))] * 3,
              "losses": [float(r)] * 3,
              "grad1": {"w": torch.tensor([float(r)])}, "after": {"w": torch.tensor([7.0])}}
             for r in range(4)]
    cap = train_ddp.global_capture(ranks, torch.device("cpu"))
    assert len(cap.batches) == 3
    assert cap.batches[0][0].flatten().tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert cap.batches[0][1].tolist() == [0, 0, 1, 1, 2, 2, 3, 3]
    assert cap.losses == [1.5] * 3
    assert float(cap.grad1["w"]) == 0.0 and float(cap.after["w"]) == 7.0


def test_swin_cell_runs_on_the_cpu_at_a_tiny_size(tmp_path, monkeypatch):
    """The cell's driver end to end (set-up, warm passes, the window, the
    mask check against the reference) at feature_size 12 on two small
    cases, and the result line without a trace."""
    cell = copy.deepcopy(Cell(load(), NEW_CELLS[0]))
    cell.config["net"]["feature_size"] = 12
    cell.config["crop"] = [64, 64, 64]
    cell.traffic.update(pool={"xy": 96, "slices": [40, 56], "spacing_xyz": [0.9, 0.9, 2.5]},
                        patch=[64, 64, 64], stride=[32, 32, 32], batch_size=2, check_masks=3)
    ctx = Context(cell, 2 ** 31 + 77, 1.0, False, str(tmp_path), device="cpu")
    run = infer_swin.run(ctx)
    assert run["correct"] and run["failed"] == 0 and run["attempted"] >= 2
    # 64^3 and 128 x 64 x 64 iso grids: one box, and three at stride 32
    assert sorted(set(run["boxes"])) == [1, 3]
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "cpu")
    out = result_line(cell, run, False)
    assert set(out["metrics"]) == {"volumes_per_min", "setup_s"}
    assert set(out["checks"]) == {"failed", "masks_unreadable", "mask_gap", "mask_disagree_05"}


def test_the_ddp_controls_take_the_exchange_between_gpus_out(monkeypatch):
    """The four-GPU cell's fault controls, as a rank applies them before
    training: DDP's wrapper hands back the bare net (no gradient
    all-reduce), and the trainer's ``distribute_`` leaves every BatchNorm
    on its rank's own rows while the z halo group still passes."""
    import torch.nn.parallel
    from portbench import control_kinds
    from segmentation3d_tpu_torch.core import seg_train
    from segmentation3d_tpu_torch.models import create_network
    from segmentation3d_tpu_torch.models.vnet import BatchNorm
    monkeypatch.setattr(torch.nn.parallel, "DistributedDataParallel",
                        torch.nn.parallel.DistributedDataParallel)
    monkeypatch.setattr(seg_train, "distribute_", seg_train.distribute_)
    assert set(Cell(load(), NEW_CELLS[1]).limits["control"]["program"]) == set(
        control_kinds.FAULTS)
    net = create_network("vnet", 1, 2, base_channels=4, down_convs=(1, 2), up_convs=(2, 1))
    control_kinds.no_allreduce()
    assert torch.nn.parallel.DistributedDataParallel(net, device_ids=None) is net
    control_kinds.local_bn()
    seg_train.distribute_(net, "world", None)
    norms = [m for m in net.modules() if isinstance(m, BatchNorm)]
    assert norms and all(m.group is None for m in norms)
