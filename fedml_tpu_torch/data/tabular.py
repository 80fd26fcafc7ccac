"""Vertically-partitioned tabular datasets (Lending Club loans, NUS-WIDE).

Port of ``fedml_tpu/data/tabular.py``.  Contract: party-split feature
matrices and binary labels, ``([Xa_train, Xb_train(, ...), y_train],
[Xa_test, ..., y_test])``.  pandas is imported when a file is read;
``synthetic_vfl_parties`` is the hermetic twin with the same return
shape."""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

VflSplit = Tuple[List[np.ndarray], List[np.ndarray]]


def _standard_scale(x: np.ndarray) -> np.ndarray:
    mu = x.mean(0, keepdims=True)
    sd = x.std(0, keepdims=True)
    return (x - mu) / np.where(sd == 0, 1.0, sd)


def load_lending_club_two_party(data_dir: str, csv_name: str = "loan.csv",
                                max_rows: Optional[int] = None) -> VflSplit:
    """Party A = qualification features, party B = loan behavior features,
    y = bad-loan indicator, 80/20 split (lending_club_dataset.py:141-162).
    Categorical columns are label-encoded; non-numeric leftovers dropped."""
    import pandas as pd
    df = pd.read_csv(os.path.join(data_dir, csv_name), nrows=max_rows,
                     low_memory=False)
    bad = {"Charged Off", "Default",
           "Does not meet the credit policy. Status:Charged Off",
           "In Grace Period", "Late (16-30 days)", "Late (31-120 days)"}
    y = df["loan_status"].isin(bad).astype(np.float32).values[:, None]
    df = df.drop(columns=["loan_status"])
    for col in df.columns:
        # text columns (object before pandas 3, str since)
        if not pd.api.types.is_numeric_dtype(df[col]):
            df[col] = df[col].astype("category").cat.codes
    df = df.fillna(0)
    # qualification-flavored columns to party A, the rest to party B
    a_cols = [c for c in df.columns if any(k in c for k in (
        "emp", "home", "annual_inc", "verification", "zip", "addr",
        "grade", "purpose"))]
    b_cols = [c for c in df.columns if c not in a_cols]
    Xa = _standard_scale(df[a_cols].values.astype(np.float32))
    Xb = _standard_scale(df[b_cols].values.astype(np.float32))
    n_tr = int(0.8 * len(y))
    return ([Xa[:n_tr], Xb[:n_tr], y[:n_tr]],
            [Xa[n_tr:], Xb[n_tr:], y[n_tr:]])


def load_nus_wide_two_party(data_dir: str, selected_labels: Sequence[str],
                            neg_label: int = -1,
                            n_samples: int = -1) -> VflSplit:
    """NUS-WIDE: Xa = concatenated low-level features (Low_Level_Features/
    *_Train.dat), Xb = 1000-d tags (NUS_WID_Tags/Tags1k), y from
    Groundtruth/TrainTestLabels — positive = first selected label
    (nus_wide_dataset.py:23-120)."""
    import pandas as pd
    lf_dir = os.path.join(data_dir, "Low_Level_Features")
    feats = []
    for fn in sorted(os.listdir(lf_dir)):
        if fn.endswith("_Train.dat"):
            feats.append(pd.read_csv(os.path.join(lf_dir, fn), sep=" ",
                                     header=None).dropna(axis=1).values)
    Xa = np.concatenate(feats, axis=1).astype(np.float32)
    Xb = pd.read_csv(
        os.path.join(data_dir, "NUS_WID_Tags", "Train_Tags1k.dat"),
        sep="\t", header=None).dropna(axis=1).values.astype(np.float32)

    lab_dir = os.path.join(data_dir, "Groundtruth", "TrainTestLabels")
    cols = []
    for lbl in selected_labels:
        v = pd.read_csv(os.path.join(lab_dir, f"Labels_{lbl}_Train.txt"),
                        header=None).values.reshape(-1)
        cols.append(v)
    L = np.stack(cols, axis=1)
    sel = L.sum(1) == 1  # examples with exactly one of the selected concepts
    y = np.where(L[sel, 0] == 1, 1, neg_label).astype(np.float32)[:, None]
    Xa, Xb = Xa[sel], Xb[sel]
    if n_samples > 0:
        Xa, Xb, y = Xa[:n_samples], Xb[:n_samples], y[:n_samples]
    n_tr = int(0.8 * len(y))
    return ([Xa[:n_tr], Xb[:n_tr], y[:n_tr]],
            [Xa[n_tr:], Xb[n_tr:], y[n_tr:]])


def synthetic_vfl_parties(n_samples: int = 256,
                          feature_dims: Sequence[int] = (16, 24),
                          seed: int = 0, neg_label: int = 0) -> VflSplit:
    """Hermetic VFL twin: k parties' features jointly linearly separate y."""
    rng = np.random.RandomState(seed)
    Xs = [rng.randn(n_samples, d).astype(np.float32) for d in feature_dims]
    ws = [rng.randn(d) for d in feature_dims]
    logits = sum(x @ w for x, w in zip(Xs, ws))
    y = np.where(logits > 0, 1, neg_label).astype(np.float32)[:, None]
    n_tr = int(0.8 * n_samples)
    return ([x[:n_tr] for x in Xs] + [y[:n_tr]],
            [x[n_tr:] for x in Xs] + [y[n_tr:]])
