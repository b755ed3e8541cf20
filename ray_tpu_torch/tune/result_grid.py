"""ResultGrid: what Tuner.fit returns (ref: python/ray/tune/result_grid.py)."""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.train.config import Result

from .trial import ERROR, Trial


class ResultGrid:
    def __init__(self, trials: List[Trial], metric: Optional[str] = None,
                 mode: str = "max"):
        self._trials = trials
        self._metric, self._mode = metric, mode

    def __len__(self):
        return len(self._trials)

    def __getitem__(self, i) -> Result:
        return self._to_result(self._trials[i])

    def __iter__(self):
        return (self._to_result(t) for t in self._trials)

    @staticmethod
    def _to_result(t: Trial) -> Result:
        r = Result(metrics=t.last_result, checkpoint=t.checkpoint,
                   error=RuntimeError(t.error) if t.error else None,
                   metrics_history=t.metric_history)
        r.config = t.config  # type: ignore[attr-defined]
        return r

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._trials if t.status == ERROR]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("no metric given to get_best_result")
        scored = [t for t in self._trials if metric in t.last_result]
        if not scored:
            raise RuntimeError("no trial reported the metric "
                               f"'{metric}'")
        best = (max if mode == "max" else min)(
            scored, key=lambda t: t.last_result[metric])
        return self._to_result(best)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for t in self._trials:
            row = {"trial_id": t.trial_id, "status": t.status}
            row.update({f"config/{k}": v for k, v in t.config.items()
                        if not isinstance(v, dict)})
            row.update({k: v for k, v in t.last_result.items()
                        if not isinstance(v, dict)})
            rows.append(row)
        return pd.DataFrame(rows)
