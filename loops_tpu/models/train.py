"""Training utilities: node-classification loss/step/eval.

Functional, optimizer-agnostic (optax), jit-ready — the training loop
surface for the GCN/GraphSAGE configs in BASELINE.json.
"""
from __future__ import annotations


def cross_entropy(logits, labels, mask=None):
    import jax
    import jax.numpy as jnp

    logp = jax.nn.log_softmax(logits)
    nll = -jnp.take_along_axis(logp, labels[:, None], axis=1)[:, 0]
    if mask is not None:
        return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return nll.mean()


def accuracy(logits, labels, mask=None):
    import jax.numpy as jnp

    hit = (logits.argmax(axis=1) == labels).astype(jnp.float32)
    if mask is not None:
        return (hit * mask).sum() / jnp.maximum(mask.sum(), 1.0)
    return hit.mean()


def make_loss_fn(model, features, labels, train_mask,
                 weight_decay: float = 0.0):
    """The training loss ``loss_fn(params, rng)`` that
    ``make_train_step`` differentiates: masked mean cross-entropy over
    the train rows, plus optional L2."""
    import jax.numpy as jnp

    features = jnp.asarray(features)
    # models may hoist static input work out of the step (e.g. GCN's
    # precompute_first: AX once, ahead of every epoch)
    prep = getattr(model, "prepare_features", None)
    if prep is not None:
        features = prep(features)
    labels = jnp.asarray(labels)
    train_mask = jnp.asarray(train_mask)

    # models that know their loss rows (GCN(loss_rows=...)) propagate
    # the last layer only to those rows; the masked cross-entropy over
    # full logits equals the plain mean over the compacted rows exactly
    loss_rows = getattr(model, "loss_rows", None)
    use_masked = loss_rows is not None
    if use_masked:
        import numpy as np
        mask_np = np.asarray(train_mask) > 0
        assert np.array_equal(np.nonzero(mask_np)[0],
                              np.asarray(loss_rows)), \
            "model.loss_rows must be the train_mask's rows"
        labels_m = jnp.asarray(np.asarray(labels)[np.asarray(loss_rows)])

    def loss_fn(params, rng):
        if use_masked:
            logits_m = model.apply(params, features, train=True, rng=rng,
                                   masked_output=True)
            loss = cross_entropy(logits_m, labels_m)
        else:
            logits = model.apply(params, features, train=True, rng=rng)
            loss = cross_entropy(logits, labels, train_mask)
        if weight_decay:
            l2 = sum(jnp.sum(p["w"] ** 2) for p in params)
            loss = loss + weight_decay * l2
        return loss

    return loss_fn


def make_train_step(model, optimizer, features, labels, train_mask,
                    weight_decay: float = 0.0):
    """Full-graph training step: (params, opt_state, rng) -> updated +
    loss. jit-compiled by the caller (or use as-is; it closes over static
    data)."""
    import jax
    import optax

    loss_fn = make_loss_fn(model, features, labels, train_mask,
                           weight_decay)

    def step(params, opt_state, rng):
        rng, sub = jax.random.split(rng)
        loss, grads = jax.value_and_grad(loss_fn)(params, sub)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, rng, loss

    return step


def make_train_epochs(model, optimizer, features, labels, train_mask,
                      steps_per_call: int = 10, weight_decay: float = 0.0):
    """``steps_per_call`` training steps per device dispatch.

    Epochs are batched through one ``lax.fori_loop`` per call, so the
    host dispatches once per ``steps_per_call`` steps. Returns
    ``epochs(params, opt_state, rng) -> (params, opt_state, rng, loss)``
    (loss from the final step); jit it once.
    """
    import jax

    step = make_train_step(model, optimizer, features, labels, train_mask,
                           weight_decay)

    def epochs(params, opt_state, rng):
        def body(_, carry):
            params, opt_state, rng, _ = carry
            return step(params, opt_state, rng)
        loss0 = jax.numpy.float32(0)
        return jax.lax.fori_loop(0, steps_per_call, body,
                                 (params, opt_state, rng, loss0))

    return epochs


def evaluate(model, params, features, labels, mask):
    import jax
    import jax.numpy as jnp

    # cache one jitted apply per model: eager evaluation dispatches
    # every op separately
    ap = getattr(model, "_jit_apply", None)
    if ap is None:
        ap = jax.jit(model.apply)
        model._jit_apply = ap
    feats = jnp.asarray(features)
    prep = getattr(model, "prepare_features", None)
    if prep is not None:
        feats = prep(feats)
    logits = ap(params, feats)
    return float(accuracy(logits, jnp.asarray(labels), jnp.asarray(mask)))
