"""Analysis tooling: t-SNE of per-pixel features, effective receptive
fields, dataset statistics, vCDR CSV evaluation. Counterpart of
``segtran_tpu/tools/analysis.py``:

  * t-SNE of saved per-pixel features        -> reference code/tsne.py
  * receptive-field visualization            -> reference internal_util.py
    :21-58 + code/receptivefield/ (gradient-based ERF: autograd in place
    of the vendored probe library)
  * dataset mean/std -> stats JSON           -> reference code/calcstat.py
  * vCDR CSV eval                            -> reference code/test-vcdr.py

The receptive-field probe input is N(0, 1) * 0.5: JAX draws it from
``PRNGKey(0)``; here the caller may pass it (``probe``), else it is drawn
from a ``torch.Generator`` seeded with 0 (the two streams differ).
Under ``--fusedepi`` the eval forward runs the fused expansion epilogue,
which has no backward (nor has JAX's Pallas epilogue): the probe then
raises ValueError, as JAX's does.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..nn.features import drop_kept_features, kept_features


def dump_pixel_features(feat: np.ndarray, mask: np.ndarray, out_path: str,
                        max_pixels: int = 20000, seed: int = 0):
    """Save per-pixel (feature, label) pairs for t-SNE (the reference's
    --savefeat dump, test_util2d.py:78-88): feat [..., C], mask [...]."""
    f = feat.reshape(-1, feat.shape[-1])
    m = mask.reshape(-1)
    rng = np.random.RandomState(seed)
    if f.shape[0] > max_pixels:
        idx = rng.choice(f.shape[0], max_pixels, replace=False)
        f, m = f[idx], m[idx]
    np.savez_compressed(out_path, features=f.astype(np.float16), labels=m)


def tsne_features(npz_path: str, perplexity: float = 30.0, seed: int = 0):
    """2-D t-SNE embedding of a feature dump (scikit-learn), or where
    scikit-learn is absent the top-2 principal components; returns
    (embedding, labels)."""
    data = np.load(npz_path)
    feats, labels = data["features"].astype(np.float32), data["labels"]
    try:
        from sklearn.manifold import TSNE
        emb = TSNE(n_components=2, perplexity=perplexity,
                   random_state=seed).fit_transform(feats)
    except ImportError:
        c = feats - feats.mean(0)
        u, s, _ = np.linalg.svd(c, full_matrices=False)
        emb = u[:, :2] * s[:2]
    return emb, labels


def hausdorff_matrix(npz_paths: Sequence[str], num_classes: int,
                     max_points_per_class: int = 2000, seed: int = 0,
                     feat_norm: bool = False) -> np.ndarray:
    """Cross-checkpoint class-wise average-Hausdorff distances (reference
    tsne.py:144-160): entry [i, ci, j, cj] is the symmetric avg-Hausdorff
    between checkpoint i's class-ci features and checkpoint j's class-cj
    features. npz_paths are --savefeat dumps (dump_pixel_features). With
    feat_norm, features are class-wise LayerNormed first (tsne.py:118-139)."""
    from ..train.contrast import avg_hausdorff_np, normalize_features_by_class
    rng = np.random.RandomState(seed)
    subsets = {}
    for i, p in enumerate(npz_paths):
        data = np.load(p)
        feats = data["features"].astype(np.float32)
        labels = np.asarray(data["labels"])
        if feat_norm:
            feats = normalize_features_by_class(feats, labels)
        for c in range(num_classes):
            f = feats[labels == c]
            if len(f) == 0:
                continue
            if len(f) > max_points_per_class:
                f = f[rng.permutation(len(f))[:max_points_per_class]]
            subsets[(i, c)] = f
    n = len(npz_paths)
    out = np.zeros((n, num_classes, n, num_classes))
    for (i, ci), f1 in subsets.items():
        for (j, cj), f2 in subsets.items():
            out[i, ci, j, cj] = avg_hausdorff_np(f1, f2)
    return out


def _probe_input(model, input_shape, probe) -> torch.Tensor:
    """[1, *input_shape] fp32 on the model's device, requiring grad."""
    dev = next(model.parameters()).device
    if probe is None:
        gen = torch.Generator().manual_seed(0)
        probe = torch.randn((1,) + tuple(input_shape), generator=gen) * 0.5
    return probe.to(dev, torch.float32).detach().requires_grad_(True)


def _centre_grad(target: torch.Tensor, x: torch.Tensor,
                 retain: bool) -> np.ndarray:
    """|d sum_c target[0, centre] / d x| averaged over x's channels."""
    t = target[0, target.shape[1] // 2, target.shape[2] // 2].sum()
    (g,) = torch.autograd.grad(t, x, retain_graph=retain)
    return g[0].abs().float().mean(-1).cpu().numpy()


def effective_receptive_field(model: torch.nn.Module, input_shape,
                              probe: Optional[torch.Tensor] = None
                              ) -> np.ndarray:
    """Gradient-based ERF of the output's centre: |d out[0, centre] /
    d input| averaged over the input channels. ``model`` in eval mode."""
    x = _probe_input(model, input_shape, probe)
    with torch.enable_grad():
        return _centre_grad(model(x), x, retain=False)


def _feature_layers(model) -> List[Tuple[str, torch.Tensor]]:
    """JAX's feat_list over the kept features: ``in_fpn`` first, then each
    translayer's tokens (``layer_{i}``) on the in-FPN grid, 4-D ones only."""
    inter = kept_features(model)
    feats, hw = [], None
    if "in_fpn_feat" in inter:
        f = inter["in_fpn_feat"]
        hw = tuple(f.shape[1:3])
        feats.append(("in_fpn", f))
    keys = sorted((k for k in inter
                   if k.startswith("voxel_fusion/") and k.endswith("_vfeat")),
                  key=lambda k: int(k.split("_")[2]))
    for k in keys:
        f = inter[k]                                        # [B, N, C]
        if hw is not None and f.dim() == 3 and f.shape[1] == hw[0] * hw[1]:
            f = f.reshape((f.shape[0],) + hw + (f.shape[-1],))
        if f.dim() == 4:
            feats.append((k[len("voxel_fusion/"):-len("_vfeat")], f))
    return feats


def layer_receptive_fields(model: torch.nn.Module, input_shape,
                           layers: Optional[Sequence[int]] = None,
                           probe: Optional[torch.Tensor] = None
                           ) -> Dict[str, np.ndarray]:
    """Per-feature-layer gradient ERF maps (the reference's ``--vis rf``:
    internal_util.py:21-58 probing each ``net.feature_maps[i]`` centre,
    segtran2d.py:316-409). Layers in the reference's feature_maps order:
    the in-FPN output, then each translayer's fused tokens on the FPN grid.
    For each selected layer i: |d sum_c feat[centre] / d input| averaged
    over the input channels ([H, W]). One eval forward keeps the features
    (their names come from it) and one backward per layer runs from it
    (JAX runs a forward and a backward per layer; the gradients are the
    same). A model that keeps no features is probed at its output (one
    ``output`` entry). ``model`` in eval mode."""
    x = _probe_input(model, input_shape, probe)
    keeps = hasattr(model, "keep_features")
    if keeps:
        model.keep_features = True
    try:
        with torch.enable_grad():
            out = model(x)
            feats = _feature_layers(model)
            if not feats:
                return {"output": _centre_grad(out, x, retain=False)}
            sel = (list(range(len(feats))) if layers is None
                   else [i for i in layers if 0 <= i < len(feats)])
            return {feats[i][0]: _centre_grad(feats[i][1], x,
                                              retain=j < len(sel) - 1)
                    for j, i in enumerate(sel)}
    finally:
        if keeps:
            model.keep_features = False
        drop_kept_features(model)


def compute_dataset_stats(dataset, sample_limit: int = 500) -> Dict:
    """Per-dataset channel mean/std over images in [0,1] (reference
    calcstat.py:42-73). Returns {'mean': [...], 'std': [...]}."""
    s = np.zeros(3)
    s2 = np.zeros(3)
    n = 0
    for i in range(min(len(dataset), sample_limit)):
        img = np.asarray(dataset[i]["image"], np.float64)
        s += img.reshape(-1, img.shape[-1]).sum(0)
        s2 += (img ** 2).reshape(-1, img.shape[-1]).sum(0)
        n += img.shape[0] * img.shape[1]
    mean = s / n
    std = np.sqrt(np.maximum(s2 / n - mean ** 2, 0))
    return {"mean": [round(float(v), 4) for v in mean],
            "std": [round(float(v), 4) for v in std]}


def write_stats_json(stats_by_ds: Dict[str, Dict], out_path: str):
    """Write the reference's stats-JSON format ({'mean': {ds: [...]}, ...})."""
    out = {"mean": {k: v["mean"] for k, v in stats_by_ds.items()},
           "std": {k: v["std"] for k, v in stats_by_ds.items()}}
    with open(out_path, "w") as f:
        json.dump(out, f, indent=4)


def vcdr_csv_eval(pred_csv: str, gt_csv: str) -> Dict[str, float]:
    """Mean absolute vCDR error between two CSVs of `name,vcdr` rows
    (reference test-vcdr.py)."""
    def read(p):
        out = {}
        with open(p) as f:
            for ln in f:
                parts = ln.strip().split(",")
                if len(parts) >= 2:
                    try:
                        out[parts[0]] = float(parts[1])
                    except ValueError:
                        continue
        return out
    pred, gt = read(pred_csv), read(gt_csv)
    common = sorted(set(pred) & set(gt))
    errs = [abs(pred[k] - gt[k]) for k in common]
    return {"mae": float(np.mean(errs)) if errs else float("nan"),
            "n": len(common)}
