"""The fused scan's survivor filter: the share of tile merges it skipped,
averaged over the window's searches (the program's counter
``SearchResult.kernel_stats["prune_skip_rate"]``, as
``ExactKNN.last_kernel_stats`` gives it), in %. It depends on the rows'
structure, so a change in the scan's time can be told apart from a change in
the work the filter leaves. Reads every ``prune_skip_pct.<group>``."""


def read(rec):
    if not rec.skip_rates:
        return None
    return 100.0 * sum(rec.skip_rates) / len(rec.skip_rates)
