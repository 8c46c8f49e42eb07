"""How far a decode step shares each expert's weight read: the rows
(assignments) the MoE blocks of the window's decode steps ran over the
experts those calls hit, from the program's counters
(``moe.decode.rows`` / ``moe.decode.experts_hit`` in
``ServeEngine.stats``). None where the program keeps no such counters."""
LAYER = "model step"
UNIT = "rows"
SOURCE = "program_counter"
MOVES = "decode_tokens_per_s"


def read(run):
    if "moe.decode.rows" not in run.stats1:
        return None
    hit = run.delta("moe.decode.experts_hit")
    return run.delta("moe.decode.rows") / hit if hit else None
