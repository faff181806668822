"""ML functions (the presto-ml module role).

Reference: presto_tpu/functions/ml.py (after presto-ml's
learn_classifier / learn_regressor / classify / regress / features over
libsvm models).  Models train on the host inside the aggregate
(exec/executor.py's learn_* branch calls train_classifier and
train_regressor below): logistic regression by full-batch gradient
descent and ridge least squares in numpy, serialized as a JSON
VARBINARY blob whose bytes are the reference's, so that a model trained
by either package applies in the other.  `classify` and `regress` apply
a model to the whole feature matrix in one product on the session's
device.

`features(x1, x2, ...)` builds an (n, k) float64 tensor typed FEATURES,
as functions/geospatial.py's point columns are.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from presto_tpu_torch import session_ctx
from presto_tpu_torch import types as T
from presto_tpu_torch.batch import upload
from presto_tpu_torch.exec.colval import ColVal, all_valid, refuse_host_read
from presto_tpu_torch.functions.decimals import true_div
from presto_tpu_torch.functions.scalar import (_is_tensor, _normalize_strings,
                                               register)

FEATURES = T.Type("FEATURES")  # device (n, k) f64 matrix
T._PHYSICAL.setdefault("FEATURES", np.int32)

MODEL = T.VARBINARY  # serialized model blob


def _feat_f64(a: ColVal):
    d = a.data
    d = d.to(torch.float64) if _is_tensor(d) else torch.full(
        (), float(d), dtype=torch.float64, device=session_ctx.device())
    if a.type.is_decimal:  # decimal data is the UNSCALED integer
        d = true_div(d, 10 ** a.type.decimal_scale)
    return d


def _emit_features(args) -> ColVal:
    cols = torch.broadcast_tensors(*[_feat_f64(a) for a in args])
    return ColVal(torch.stack(cols, dim=-1), all_valid(*args), FEATURES)


register("features",
         lambda args: FEATURES if args and all(a.is_numeric for a in args)
         else None,
         _emit_features)


# ---------------------------------------------------------------------------
# model blobs
# ---------------------------------------------------------------------------


def _pack_model(kind: str, weights: np.ndarray, bias,
                classes=None) -> bytes:
    return json.dumps({
        "kind": kind,
        "w": np.asarray(weights, np.float64).tolist(),
        "b": (np.asarray(bias, np.float64).tolist()
              if hasattr(bias, "__len__") else float(bias)),
        "classes": None if classes is None else list(classes),
    }).encode()


def _unpack_model(blob) -> dict:
    if isinstance(blob, str):
        blob = blob.encode()
    return json.loads(bytes(blob).decode())


def train_classifier(labels: np.ndarray, feats: np.ndarray,
                     iters: int = 300, lr: float = 0.5) -> bytes:
    """Multinomial logistic regression by full-batch gradient descent
    (the LibSvmClassifier role; classes = the distinct labels)."""
    classes, y = np.unique(labels, return_inverse=True)
    n, k = feats.shape
    c = len(classes)
    mu = feats.mean(axis=0)
    sd = feats.std(axis=0)
    sd[sd == 0] = 1.0
    x = (feats - mu) / sd
    w = np.zeros((k, c))
    b = np.zeros(c)
    onehot = np.eye(c)[y]
    for _ in range(iters):
        z = x @ w + b
        z -= z.max(axis=1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        g = (p - onehot) / n
        w -= lr * (x.T @ g + 1e-4 * w)
        b -= lr * g.sum(axis=0)
    # fold the standardization into the weights: z = ((f-mu)/sd)w + b
    w_raw = w / sd[:, None]
    b_raw = b - mu @ w_raw
    return _pack_model("classifier", w_raw, b_raw,
                       [v.item() if hasattr(v, "item") else v
                        for v in classes])


def train_regressor(labels: np.ndarray, feats: np.ndarray) -> bytes:
    """Ridge least squares (the LibSvmRegressor role)."""
    n, k = feats.shape
    xb = np.hstack([feats, np.ones((n, 1))])
    ident = np.eye(k + 1) * 1e-8
    ident[-1, -1] = 0.0
    coef = np.linalg.solve(xb.T @ xb + ident, xb.T @ labels)
    return _pack_model("regressor", coef[:-1], coef[-1])


# ---------------------------------------------------------------------------
# inference scalars (one product over the column on the device)
# ---------------------------------------------------------------------------


def _model_of(v: ColVal):
    if v.dictionary is not None and (not _is_tensor(v.data)
                                     or v.data.ndim == 0):
        code = v.data
        if _is_tensor(code):
            refuse_host_read("a computed model code")
            code = code.item()
        return _unpack_model(v.dictionary.values[int(code)])
    if isinstance(v.data, (bytes, str)):
        return _unpack_model(v.data)
    if v.dictionary is not None and v.data.ndim == 1:
        # the model as a per-row column (the canonical CROSS JOIN form):
        # one distinct model applies to the whole column
        if len(v.dictionary) == 1:
            return _unpack_model(v.dictionary.values[0])
        refuse_host_read("a model column's distinct codes")
        codes = np.unique(v.data.cpu().numpy())
        if len(codes) == 1:
            return _unpack_model(v.dictionary.values[int(codes[0])])
        raise NotImplementedError(
            "classify/regress with multiple distinct models in one "
            "column")
    return None


def _emit_apply(kind):
    def emit(args):
        feats, model = args
        m = _model_of(model)
        if m is None or m.get("kind") != kind:
            raise ValueError(f"{kind} model expected")
        x = feats.data
        if x.ndim == 1:
            x = x[None, :]
        w = upload(np.asarray(m["w"], np.float64), x.device)
        b = upload(np.asarray(m["b"], np.float64), x.device)
        z = x @ w + b  # one product for the whole column
        if kind == "regressor":
            out = z if z.ndim == 1 else z.reshape(x.shape[0])
            return ColVal(out, all_valid(*args), T.DOUBLE)
        idx = torch.argmax(z, dim=-1).to(torch.int32)
        # type-stable: labels always come back as VARCHAR (the
        # reference's classify is varchar-typed too)
        return _normalize_strings([str(c) for c in m["classes"]],
                                  ColVal(idx, all_valid(*args), T.VARCHAR))

    return emit


register("classify", lambda args: T.VARCHAR if len(args) == 2 else None,
         _emit_apply("classifier"))
register("regress", lambda args: T.DOUBLE if len(args) == 2 else None,
         _emit_apply("regressor"))
