"""The full experiment pipeline: verify → localize → repair → route → audit.

Port of ``fairify_tpu/analysis/experiment.py`` (the reference's experiment
drivers, ``src/AC/Verify-AC-experiment-new2.py:562-794``, and the
detect_bias/new_model stages they feed):

1. run the verification sweep for one model (partition verdict memo);
2. collect validated counterexample pairs;
3. localize biased neurons from the pairs (``src/AC/detect_bias.py:205-302``);
4. repair: masked fine-tune on the biased neurons *and/or* two-stage
   counterexample retraining (``src/AC/new_model.py:179-263``) — rows 26-28
   on the card;
5. re-verify the repaired net over the same grid;
6. hybrid-route test points by partition verdict
   (``Verify-AC-experiment-new2.py:613-638``);
7. audit original vs fairer vs hybrid with group metrics + causal
   discrimination rates (``:653-787``).

Steps 5-7 are :func:`audit`, which a caller can also run on carried
weights.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from fairify_tpu_torch.analysis import causal as causal_mod
from fairify_tpu_torch.analysis import hybrid as hybrid_mod
from fairify_tpu_torch.analysis import localize as localize_mod
from fairify_tpu_torch.analysis import repair as repair_mod
from fairify_tpu_torch.data import loaders
from fairify_tpu_torch.models import mlp as mlp_mod
from fairify_tpu_torch.utils.num import resolve_device
from fairify_tpu_torch.verify import sweep as sweep_mod
from fairify_tpu_torch.verify.config import SweepConfig


@dataclass
class ExperimentResult:
    report: sweep_mod.ModelReport
    ce_pairs: List[Tuple[np.ndarray, np.ndarray]]
    localization: Optional[localize_mod.BiasLocalization]
    fairer_net: object
    metrics: Dict[str, dict] = field(default_factory=dict)
    causal_rates: Dict[str, float] = field(default_factory=dict)
    # Verdict profile of the REPAIRED model over the same grid, routing
    # counts and the asserted success criteria.
    fairer_verdicts: Optional[Dict[str, int]] = None
    routing: Optional[Dict[str, int]] = None
    success: Optional[Dict[str, bool]] = None
    # The repair's own records (the port's addition): each arm's history.
    repair_history: Dict[str, list] = field(default_factory=dict)


def repair_success(
    metrics: Dict[str, dict],
    causal_rates: Dict[str, float],
    accuracy_floor: Optional[float] = None,
    group_tol: Optional[float] = None,
) -> Dict[str, bool]:
    """The reference pipeline's own bar, asserted: causal rate down, DI
    toward 1, |SPD|/|EOD|/|AOD| not worse, accuracy above the floor
    (``src/AC/new_model.py:248-260``); one boolean per criterion plus the
    conjunction under ``passed``."""
    before, after = metrics["original"], metrics["fairer"]
    if accuracy_floor is None:
        accuracy_floor = repair_mod.derive_accuracy_floor(before["accuracy"])
    tol = group_tol if group_tol is not None else repair_mod.GROUP_TOL
    out = {
        "causal_rate_down": causal_rates.get("fairer", np.inf)
        <= causal_rates.get("original", 0.0),
        "di_toward_1": repair_mod.di_not_worse(
            after["disparate_impact"], before["disparate_impact"], tol),
        "spd_not_worse": repair_mod.magnitude_not_worse(
            after["statistical_parity_difference"],
            before["statistical_parity_difference"], tol),
        "eod_not_worse": repair_mod.magnitude_not_worse(
            after["equal_opportunity_difference"],
            before["equal_opportunity_difference"], tol),
        "aod_not_worse": repair_mod.magnitude_not_worse(
            after["average_odds_difference"],
            before["average_odds_difference"], tol),
        "accuracy_floor": after["accuracy"] >= accuracy_floor,
    }
    out["passed"] = all(out.values())
    return out


def audit(net, fairer, cfg: SweepConfig, model_name: str, ds, report,
          causal_samples: int = 2000, verify_repaired: bool = True, mesh=None,
          device=None) -> dict:
    """Steps 5-7 for the original ``net`` and its repair ``fairer`` after the
    sweep ``report``: ``fairer_verdicts`` (None unless the net changed and
    ``verify_repaired``), ``metrics``, ``routing`` and ``causal_rates``."""
    query = cfg.query()
    pa_col = query.columns.index(query.protected[0])
    fairer_verdicts = None
    if verify_repaired and fairer is not net:
        rep_cfg = cfg.with_(result_dir=cfg.result_dir.rstrip("/") + "-repaired")
        fairer_verdicts = sweep_mod.verify_model(
            fairer, rep_cfg, model_name=f"{model_name}-repaired", dataset=ds, mesh=mesh,
            device=device).counts

    # Hybrid routing over the sweep's own partition grid + verdict memo.
    _, lo, hi = sweep_mod.build_partitions(cfg)
    attempted = len(report.outcomes)
    verdicts = [o.verdict for o in report.outcomes]
    metrics_out, routing_rep = hybrid_mod.evaluate_hybrid(
        ds.X_test, ds.y_test, pa_col, net, fairer,
        lo[:attempted], hi[:attempted], verdicts,
    )
    routing = {"fair": routing_rep.routed_fair,
               "original": routing_rep.routed_original,
               "miss": routing_rep.routed_miss}

    # Black-box causal audit of all three predictors on the query domain.
    dlo, dhi = query.domain.lo_hi()
    hybrid_fn = lambda X: hybrid_mod.hybrid_predict(
        X, net, fairer, lo[:attempted], hi[:attempted], verdicts).predictions
    causal_rates = {}
    for name, pred in (
        ("original", lambda X: mlp_mod.predict_rows(net, X)),
        ("fairer", lambda X: mlp_mod.predict_rows(fairer, X)),
        ("hybrid", hybrid_fn),
    ):
        causal_rates[name] = causal_mod.causal_discrimination(
            pred, dlo.astype(np.int64), dhi.astype(np.int64), pa_col,
            min_samples=200, max_samples=causal_samples,
        ).rate
    return dict(fairer_verdicts=fairer_verdicts, metrics=metrics_out, routing=routing,
                causal_rates=causal_rates)


def run_experiment(
    net,
    cfg: SweepConfig,
    model_name: str,
    dataset: Optional[loaders.LoadedDataset] = None,
    repair_mode: str = "retrain",  # 'masked' | 'retrain' | 'both'
    top_k_neurons: int = 5,
    causal_samples: int = 2000,
    verify_repaired: bool = True,
    mesh=None,
    device=None,
) -> ExperimentResult:
    """The JAX function's parameters, then ``device`` (default ``cuda``;
    ``"cpu"`` runs the plain versions of the kernels); the net is moved
    there (with a ``mesh`` and no ``device``: the mesh's first device)."""
    dev = resolve_device(mesh.home if mesh is not None and device is None else device)
    net = net.to(dev)
    ds = dataset or loaders.load(cfg.dataset)
    query = cfg.query()
    report = sweep_mod.verify_model(net, cfg, model_name=model_name, dataset=ds, mesh=mesh,
                                    device=dev)

    pairs = [o.counterexample for o in report.outcomes if o.counterexample]
    pa_idx = [query.columns.index(a) for a in query.protected]

    loc = localize_mod.localize(net, pairs, pa_idx, top_k=top_k_neurons) if pairs else None

    fairer = net
    history = {}
    if pairs and repair_mode in ("masked", "both") and loc and loc.ranked:
        targets = [(l, j) for l, j, _ in loc.ranked]
        res = repair_mod.masked_repair(fairer, targets, ds.X_train, ds.y_train, epochs=3)
        fairer, history["masked"] = res.net, res.history
    if pairs and repair_mode in ("retrain", "both"):
        res = repair_mod.counterexample_retrain(
            fairer, ds.X_train, ds.y_train, pairs, ds.X_test, ds.y_test,
            protected_col=pa_idx[0])
        fairer, history["retrain"] = res.net, res.history

    out = audit(net, fairer, cfg, model_name, ds, report, causal_samples=causal_samples,
                verify_repaired=verify_repaired, mesh=mesh, device=dev)
    return ExperimentResult(
        report=report,
        ce_pairs=pairs,
        localization=loc,
        fairer_net=fairer,
        metrics=out["metrics"],
        causal_rates=out["causal_rates"],
        fairer_verdicts=out["fairer_verdicts"],
        routing=out["routing"],
        success=(repair_success(out["metrics"], out["causal_rates"])
                 if fairer is not net else None),
        repair_history=history,
    )
