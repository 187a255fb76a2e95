"""mbp_per_s: input megabases (forward strand) times the calls completed,
over the wall seconds from the first timed call's start to the last one's
end. All the work over all the time: a call that stalls moves it."""


def read(rec):
    done = [c for c in rec["calls"] if c["ok"]]
    if not done:
        return None
    wall = max(c["end"] for c in done) - min(c["start"] for c in done)
    return rec["mbp"] * len(done) / wall
