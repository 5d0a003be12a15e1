"""INT8 model quantization (port of
``incubator_mxnet_tpu/contrib/quantization.py``).

Flow: rewrite FullyConnected/Convolution nodes into quantize_v2 ->
quantized op (int8 x int8 -> int32, ``ops/quantization.py``) ->
dequantize; calibrate per-tensor ranges over a calibration set either by
min/max (``'naive'``) or by KL-divergence-optimal thresholds
(``'entropy'``).  The rewrites work on the port's ``symbol/symbol.py``
graphs and give the reference's graphs node for node; the KL search is
the reference's numpy, copied.  Calibration binds the graph on ``ctx``
(None: the card) and reads every node's output through
``Executor.set_monitor_callback``.

On the int8 wire a max pool runs on int8 codes: the port's max pooling
sends integers to its plain path (padding with the dtype's lowest value),
as the reference sends them to ``lax.reduce_window``, not to the
argmax-storing kernel (K3).
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["quantize_model", "quantize_graph", "fold_batch_norm",
           "_get_optimal_threshold"]

_QUANTIZABLE = {"FullyConnected": "_contrib_quantized_fully_connected",
                "Convolution": "_contrib_quantized_conv"}


def fold_batch_norm(sym, arg_params, aux_params):
    """Inference-time BN folding: Convolution→BatchNorm collapses into one
    Convolution with rescaled weights and a bias.

    w' = w * (gamma / sqrt(var + eps)) per output channel,
    b' = beta - mean * gamma / sqrt(var + eps)  (+ b * gamma / sqrt(...)).

    The reference reaches the same graph via the MKLDNN subgraph fusion
    (src/operator/subgraph/mkldnn/mkldnn_conv.cc); here it is a symbol
    rewrite so the int8 pass sees conv(+bias)→relu chains with no f32
    BatchNorm forcing a dequantize/quantize boundary around every conv.
    Returns (folded_sym, new_arg_params, new_aux_params).
    """
    from ..ndarray import ndarray as _nd
    from ..symbol.symbol import Symbol, _Node, _toposort

    args = dict(arg_params)
    aux = dict(aux_params)
    old_nodes = _toposort([n for n, _ in sym._outputs])
    # fan-out per node: only fold a conv consumed solely by its BN
    fanout: Dict[int, int] = {}
    for node in old_nodes:
        for p, _i in node.inputs:
            fanout[id(p)] = fanout.get(id(p), 0) + 1
    for node, _i in sym._outputs:
        fanout[id(node)] = fanout.get(id(node), 0) + 1

    mapping: Dict[int, _Node] = {}
    for node in old_nodes:
        if node.is_var:
            mapping[id(node)] = node
            continue
        new_inputs = [(mapping[id(p)], i) for p, i in node.inputs]
        src = node.inputs[0][0] if node.inputs else None
        bn_axis = int(node.attrs.get("axis", 1)) if node.attrs else 1
        conv_layout = str(src.attrs.get("layout", "None")) \
            if (src is not None and not src.is_var) else "None"
        if node.op in ("BatchNorm", "batch_norm") and src is not None \
                and not src.is_var and src.op == "Convolution" \
                and fanout.get(id(src), 0) == 1 and bn_axis == 1 \
                and (conv_layout in ("None", "") or
                     conv_layout.startswith("NC")):
            # inference fold uses the moving statistics (aux states);
            # guarded to channel-first layouts with BN over axis 1 — any
            # other combination keeps the BN node (fold would rescale the
            # wrong weight axis silently)
            conv = src
            conv_mapped = mapping[id(conv)]
            wname = conv.inputs[1][0].name
            has_bias = (len(conv.inputs) >= 3
                        and not (conv.inputs[2][0].is_var
                                 and conv.inputs[2][0].name == "__null__")
                        and str(conv.attrs.get("no_bias",
                                               "False")) in ("False", "0"))
            gamma_n = node.inputs[1][0].name
            beta_n = node.inputs[2][0].name
            mean_n = node.inputs[3][0].name
            var_n = node.inputs[4][0].name
            if wname not in args or mean_n not in aux or var_n not in aux:
                mapping[id(node)] = _Node(node.op, node.name,
                                          dict(node.attrs), new_inputs,
                                          num_outputs=node.num_outputs)
                continue
            eps = float(node.attrs.get("eps", 1e-3))
            fix_gamma = str(node.attrs.get("fix_gamma", "True")) \
                not in ("False", "0")
            w = args[wname].asnumpy()
            gamma = (np.ones(w.shape[0], np.float32) if fix_gamma
                     or gamma_n not in args
                     else args[gamma_n].asnumpy())
            beta = (args[beta_n].asnumpy() if beta_n in args
                    else np.zeros(w.shape[0], np.float32))
            mean = aux[mean_n].asnumpy()
            var = aux[var_n].asnumpy()
            scale = gamma / np.sqrt(var + eps)
            w_f = (w * scale.reshape((-1,) + (1,) * (w.ndim - 1))) \
                .astype(np.float32)
            b_old = (args[conv.inputs[2][0].name].asnumpy()
                     if has_bias else np.zeros(w.shape[0], np.float32))
            b_f = (beta - mean * scale + b_old * scale).astype(np.float32)
            # keyed by the CONV name: a shared weight var feeding two
            # conv+BN pairs must not collide on the folded param names
            wf_name = conv.name + "_bnfold_weight"
            bf_name = conv.name + "_bnfold_bias"
            where = args[wname].context
            args[wf_name] = _nd.array(w_f, ctx=where)
            args[bf_name] = _nd.array(b_f, ctx=where)
            wf_var = _Node(None, wf_name)
            bf_var = _Node(None, bf_name)
            attrs = dict(conv.attrs)
            attrs["no_bias"] = False
            folded = _Node("Convolution", conv.name + "_bnfold", attrs,
                           [conv_mapped.inputs[0], (wf_var, 0),
                            (bf_var, 0)])
            mapping[id(node)] = folded
            continue
        mapping[id(node)] = _Node(node.op, node.name, dict(node.attrs),
                                  new_inputs, num_outputs=node.num_outputs)

    folded_sym = Symbol([(mapping[id(n)], i) for n, i in sym._outputs])
    keep_args = set(folded_sym.list_arguments())
    keep_aux = set(folded_sym.list_auxiliary_states())
    return (folded_sym,
            {k: v for k, v in args.items() if k in keep_args},
            {k: v for k, v in aux.items() if k in keep_aux})


def _get_optimal_threshold(arr, num_bins=1001, num_quantized_bins=255):
    """KL-divergence-optimal |threshold| (calibrate.cc entropy mode).

    Builds a histogram of |x| and picks the clip threshold whose clipped+
    re-quantized distribution minimizes KL(P||Q) against the original."""
    arr = np.abs(np.asarray(arr, np.float64).ravel())
    amax = arr.max() if arr.size else 0.0
    if amax == 0.0:
        return 0.0
    hist, edges = np.histogram(arr, bins=num_bins, range=(0, amax))
    return _entropy_threshold_from_hist(hist, edges, num_quantized_bins)


def _entropy_threshold_from_hist(hist, edges, num_quantized_bins=255):
    """Histogram-input form of the KL search — also the body of the
    `_contrib_calibrate_entropy` op (calibrate.cc takes hist+edges)."""
    hist = np.asarray(hist, np.float64)
    edges = np.asarray(edges, np.float64)
    num_bins = len(hist)
    amax = float(edges[-1])
    total = hist.sum()
    if total == 0:
        return float(amax)

    best_kl = np.inf
    best_thr = amax
    # candidates start at num_quantized_bins: below that, re-quantizing
    # into 255 levels is lossless and KL≈0 regardless of clipping error,
    # which would always select a (wrong) tiny threshold
    for i in range(num_quantized_bins, num_bins + 1,
                   max(1, num_bins // 64)):
        p = hist[:i].astype(np.float64).copy()
        p[i - 1] += hist[i:].sum()        # clip outliers into last bin
        thr = edges[i]
        # quantize p into num_quantized_bins then expand back
        chunks = np.array_split(p, num_quantized_bins)
        q = np.concatenate([
            np.full(len(c), c.sum() / max((c > 0).sum(), 1))
            * (c > 0) for c in chunks])
        p_n = p / p.sum()
        q_n = q / q.sum() if q.sum() > 0 else q
        mask = (p_n > 0) & (q_n > 0)
        if not mask.any():
            continue
        kl = float(np.sum(p_n[mask] * np.log(p_n[mask] / q_n[mask])))
        if kl < best_kl:
            best_kl = kl
            best_thr = thr
    return float(best_thr)


def _collect_layer_stats(sym, arg_params, aux_params, calib_data,
                         data_names, ctx, max_batches, mode):
    """Run calibration batches, recording per-node-output ranges through
    the executor's monitor callback (the MXNet CalibrationCollector
    analog).  ``ctx`` None binds on the card."""
    collected: Dict[str, List[np.ndarray]] = {}

    def callback(name, array):
        collected.setdefault(name, []).append(array.asnumpy())

    exe = None
    n = 0
    for batch in calib_data:
        data = batch.data[0] if hasattr(batch, "data") else batch[0]
        if exe is None:
            feed = {data_names[0]: data}
            feed.update(arg_params)
            exe = sym.bind(ctx, feed,
                           aux_states=dict(aux_params))
            exe.set_monitor_callback(callback)
        else:
            exe.arg_dict[data_names[0]][:] = data
        exe.forward(is_train=False)
        n += 1
        if max_batches is not None and n >= max_batches:
            break
    if hasattr(calib_data, "reset"):
        calib_data.reset()

    ranges = {}
    for name, chunks in collected.items():
        flat = np.concatenate([c.ravel() for c in chunks])
        if mode == "entropy":
            thr = _get_optimal_threshold(flat)
            ranges[name] = (-thr, thr)
        else:
            ranges[name] = (float(flat.min()), float(flat.max()))
    return ranges


def quantize_graph(sym, excluded_sym_names=(), calib_ranges=None,
                   weight_ranges=None):
    """Symbol rewrite: FC/Conv → quantize_v2 + quantized op + dequantize
    (quantize_graph_pass.cc)."""
    from ..symbol.symbol import Symbol, _Node, _toposort

    calib_ranges = calib_ranges or {}
    excluded = set(excluded_sym_names)
    old_nodes = _toposort([n for n, _ in sym._outputs])
    mapping = {}
    uid = [0]

    def new_node(op, hint, attrs, entries, num_outputs=1):
        uid[0] += 1
        return _Node(op, "%s_q%d" % (hint, uid[0]), attrs, entries,
                     num_outputs=num_outputs)

    # int8-commuting ops: monotone + zero-preserving under the symmetric
    # int8 map (relu, max-pool) or pure data movement: a dequantize
    # followed only by these then a re-quantize is replaced by ONE
    # requantize (int32 -> int8) with the chain replayed on the int8
    # tensor (quantize_graph_pass.cc requantize insertion), so no
    # activation goes through f32 between quantized convs
    def _commutes(n):
        if n.op in ("relu", "Flatten", "Reshape", "reshape"):
            return True
        if n.op == "Activation" and str(
                n.attrs.get("act_type", "relu")) == "relu":
            return True
        if n.op == "Pooling" and str(
                n.attrs.get("pool_type", "max")) == "max":
            return True
        return False

    _rq_cache = {}

    def int8_source(entry):
        """If ``entry`` (in the NEW graph) is dequantize∘[commuting ops],
        return (int8_entry, min_entry, max_entry) on the int8 path.
        Requantize + replayed links are cached per source node so fanout
        consumers share one int8 materialization."""
        chain = []
        n, _i = entry
        while not n.is_var and n.op != "_contrib_dequantize":
            if not _commutes(n) or not n.inputs:
                return None
            chain.append(n)
            n, _i = n.inputs[0]
        if n.is_var or n.op != "_contrib_dequantize":
            return None
        if id(entry[0]) in _rq_cache:
            return _rq_cache[id(entry[0])]
        acc, mn, mx = n.inputs[0], n.inputs[1], n.inputs[2]
        if id(n) in _rq_cache:
            cur, cmin, cmax = _rq_cache[id(n)]
        elif acc[0].op in ("_contrib_quantized_elemwise_add",
                           "_contrib_requantize"):
            # producer is already int8 with its own ranges: reuse directly
            # (a second requantize would re-round and rescan for nothing)
            cur, cmin, cmax = acc, mn, mx
            _rq_cache[id(n)] = (cur, cmin, cmax)
        else:
            # the dequantize node carries the ORIGINAL op's name, so the
            # calibration table's "<name>_output" range applies to this
            # requantize — without it every activation pays a full
            # data-dependent abs-max rescan and entropy calibration is dead
            rattrs = {}
            ckey = "%s_output" % n.name
            if ckey in calib_ranges:
                rattrs = {"min_calib_range": calib_ranges[ckey][0],
                          "max_calib_range": calib_ranges[ckey][1]}
            rq = new_node("_contrib_requantize", "requant", rattrs,
                          [acc, mn, mx], num_outputs=3)
            cur, cmin, cmax = (rq, 0), (rq, 1), (rq, 2)
            _rq_cache[id(n)] = (cur, cmin, cmax)
        for link in reversed(chain):
            replay = new_node(link.op, link.name + "_int8",
                              dict(link.attrs), [cur])
            cur = (replay, 0)
        out = (cur, cmin, cmax)
        _rq_cache[id(entry[0])] = out
        return out

    for node in old_nodes:
        if node.is_var:
            mapping[id(node)] = node
            continue
        new_inputs = [(mapping[id(p)], i) for p, i in node.inputs]
        if node.op in ("elemwise_add", "_plus", "_Plus", "broadcast_add") \
                and node.name not in excluded and len(new_inputs) == 2:
            # residual adds stay on the int8 wire when both operands are
            # int8-resolvable (quantized_elemwise_add.cc) — the bottleneck
            # exit otherwise forces dequantize+quantize around every block
            lhs8 = int8_source(new_inputs[0])
            rhs8 = int8_source(new_inputs[1])
            if lhs8 is not None and rhs8 is not None:
                (le, lmin, lmax), (re_, rmin, rmax) = lhs8, rhs8
                qadd = new_node("_contrib_quantized_elemwise_add",
                                node.name + "_qadd", {},
                                [le, re_, lmin, lmax, rmin, rmax],
                                num_outputs=3)
                deq = _Node("_contrib_dequantize", node.name, {},
                            [(qadd, 0), (qadd, 1), (qadd, 2)])
                mapping[id(node)] = deq
                continue
        if node.op in _QUANTIZABLE and node.name not in excluded \
                and len(new_inputs) >= 2:
            qop = _QUANTIZABLE[node.op]
            # quantize data input (calibrated range if known)
            data_entry = new_inputs[0]
            dkey = "%s_output" % data_entry[0].name
            dattrs = {}
            if dkey in calib_ranges:
                dattrs = {"min_calib_range": calib_ranges[dkey][0],
                          "max_calib_range": calib_ranges[dkey][1]}
            elif data_entry[0].is_var and data_entry[0].name in calib_ranges:
                lo, hi = calib_ranges[data_entry[0].name]
                dattrs = {"min_calib_range": lo, "max_calib_range": hi}
            src8 = int8_source(data_entry)
            if src8 is not None:
                d_entry, d_min, d_max = src8
            else:
                qdata = new_node("_contrib_quantize_v2", "qdata", dattrs,
                                 [data_entry], num_outputs=3)
                d_entry, d_min, d_max = (qdata, 0), (qdata, 1), (qdata, 2)
            wattrs = {}
            wname = new_inputs[1][0].name
            if weight_ranges and wname in weight_ranges:
                lo, hi = weight_ranges[wname]
                wattrs = {"min_calib_range": lo, "max_calib_range": hi}
            qweight = new_node("_contrib_quantize_v2", "qweight", wattrs,
                               [new_inputs[1]], num_outputs=3)
            has_bias = len(new_inputs) >= 3 and not (
                new_inputs[2][0].is_var
                and new_inputs[2][0].name == "__null__")
            if has_bias:
                qbias = new_node("_contrib_quantize_v2", "qbias", {},
                                 [new_inputs[2]], num_outputs=3)
                bias_entries = [(qbias, 0)]
                bias_ranges = [(qbias, 1), (qbias, 2)]
            else:
                from ..symbol import _NULL_NODE
                bias_entries = [(_NULL_NODE, 0)]
                bias_ranges = [(_NULL_NODE, 0), (_NULL_NODE, 0)]
            q_attrs = dict(node.attrs)
            q_entries = ([d_entry, (qweight, 0)] + bias_entries +
                         [d_min, d_max, (qweight, 1),
                          (qweight, 2)] + bias_ranges)
            qnode = new_node(qop, node.name + "_quantized", q_attrs,
                             q_entries, num_outputs=3)
            deq = _Node("_contrib_dequantize", node.name,
                        {}, [(qnode, 0), (qnode, 1), (qnode, 2)])
            mapping[id(node)] = deq
        else:
            nn_ = _Node(node.op, node.name, dict(node.attrs), new_inputs,
                        num_outputs=node.num_outputs)
            mapping[id(node)] = nn_

    return Symbol([(mapping[id(n)], i) for n, i in sym._outputs])


def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   excluded_sym_names=(), ctx=None, calib_mode="none",
                   calib_data=None, num_calib_examples=None,
                   quantized_dtype="int8", logger=None):
    """Quantize a model (contrib/quantization.py:430).

    calib_mode: 'none' (dynamic ranges), 'naive' (min/max over calib
    data), or 'entropy' (KL-optimal thresholds)."""
    assert quantized_dtype in ("int8", "auto"), \
        "the int8 path is symmetric signed"
    calib_ranges = {}
    if calib_mode in ("naive", "entropy"):
        assert calib_data is not None, \
            "calib_mode %r requires calib_data" % calib_mode
        batches = None
        if num_calib_examples is not None:
            bs = getattr(calib_data, "batch_size", 1) or 1
            batches = max(1, num_calib_examples // bs)
        calib_ranges = _collect_layer_stats(
            sym, arg_params, aux_params, calib_data, list(data_names), ctx,
            batches, calib_mode)
    qsym = quantize_graph(sym, excluded_sym_names, calib_ranges)
    return qsym, dict(arg_params), dict(aux_params)
