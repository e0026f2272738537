"""Sync policy for metrics whose state includes raw Python sentences
(BERTScore, InfoLM; port of ``tpumetrics/text/_sentence_state.py``).

Strings live outside the tensor sync path. Across processes they travel
through the backend's ``all_gather_object`` host-object channel
(``torch.distributed.all_gather_object`` under a
:class:`~tpumetrics_torch.parallel.backend.TorchDistBackend`). A backend with
no object channel refuses, unless the caller declares the corpus replicated
on every rank."""

from __future__ import annotations

from tpumetrics_torch.utils.exceptions import TPUMetricsUserError


class HostSentenceStateMixin:
    """Mixin syncing host-side sentence buffers via object-gather.

    Subclasses set ``self.sentences_replicated`` in ``__init__`` and keep
    their sentence buffers in ``self._preds`` / ``self._target``.
    """

    sentences_replicated: bool = False
    _sentence_cache = None

    @property
    def sentence_state(self):
        """The accumulated (predictions, references) sentence lists: the
        public handle for a manual multi-host object-gather (gather both
        lists from every rank, feed the union into one metric, compute
        once). Returns copies; mutating them does not touch the metric."""
        return list(self._preds), list(self._target)

    def _sync_dist(self, dist_sync_fn=None, process_group=None, _reducer=None):
        if self.sentences_replicated:
            # tensor states sync normally; the sentence lists are identical by declaration. A custom
            # dist_sync_fn alone is not enough: it only sees the tensor states, never the strings.
            return super()._sync_dist(dist_sync_fn=dist_sync_fn, process_group=process_group, _reducer=_reducer)

        if getattr(self, "dist_sync_on_step", False):
            # forward()'s in-step sync saves and restores registered states only; the unregistered sentence
            # lists would be merged but never restored
            raise TPUMetricsUserError(
                f"{type(self).__name__} keeps raw sentences as host-side state and does"
                " not support dist_sync_on_step=True (forward's per-step sync cannot"
                " restore host-side sentence buffers). Sync once at compute() instead,"
                " or replicate sentences on every rank with sentences_replicated=True."
            )
        if dist_sync_fn is not None:
            # a custom gather fn only ever sees the tensor states: it would merge them while keeping one
            # rank's sentence shard
            raise TPUMetricsUserError(
                f"{type(self).__name__} keeps raw sentences as host-side state; a custom"
                " dist_sync_fn cannot move them (it only sees array states). Either"
                " drop dist_sync_fn (the backend's host-object channel syncs sentences),"
                " compute per process and aggregate the returned scores, or replicate"
                " the sentences to every rank and construct with"
                " sentences_replicated=True."
            )

        backend = self._active_backend()
        group = process_group or self.process_group
        try:
            gathered = backend.all_gather_object((list(self._preds), list(self._target)), group=group)
        except NotImplementedError:
            raise TPUMetricsUserError(
                f"{type(self).__name__} keeps raw sentences as host-side state, and the"
                f" active backend ({type(backend).__name__}) has no host-object channel"
                " to sync them (in-trace collectives move arrays only). Either compute"
                " per process and aggregate the returned scores, or replicate the"
                " sentences to every rank before update() and construct with"
                " sentences_replicated=True (or sync_on_compute=False)."
            ) from None
        # the tensor states first: if that fails, the sentence buffers are untouched and a retried sync
        # gathers the local shard again (under a shared reducer the tensor reductions wait for the returned
        # finalize; the sentence swap below is immediate)
        finalize = super()._sync_dist(dist_sync_fn=dist_sync_fn, process_group=process_group, _reducer=_reducer)
        self._sentence_cache = (self._preds, self._target)
        self._preds = [p for rank_preds, _ in gathered for p in rank_preds]
        self._target = [t for _, rank_target in gathered for t in rank_target]
        return finalize

    def unsync(self, should_unsync: bool = True) -> None:
        super().unsync(should_unsync)
        if should_unsync and self._sentence_cache is not None:
            self._preds, self._target = self._sentence_cache
            self._sentence_cache = None

    def reset(self) -> None:
        super().reset()
        self._sentence_cache = None
