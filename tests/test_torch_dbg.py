"""The port's break-in debugger (``utils/dbg.py``) against the JAX
package's, on the CPU: the same command script on equal states prints the
same text (exact), and the mirrors of ``tests/test_dbg.py`` (printing,
live-ε editing, abort, ESC polling without a tty, the CLI's ``--dbg``)."""

import io

import numpy as np
import pytest
import torch

from mcmc_colorer_tpu.config import MCMCParams as JParams
from mcmc_colorer_tpu.models.chain_api import SteppedMCMC as JStepped
from mcmc_colorer_tpu.utils.dbg import DebugAttach as JDebugAttach

from mcmc_colorer_tpu_torch import interop
from mcmc_colorer_tpu_torch.cli import main as cli_main
from mcmc_colorer_tpu_torch.config import MCMCParams
from mcmc_colorer_tpu_torch.models.chain_api import SteppedMCMC
from mcmc_colorer_tpu_torch.utils.dbg import DebugAttach, esc_pending
from mcmc_colorer_tpu_torch.utils.rng import TorchUniformSource

from test_torch_mcmc import port_params

torch.set_num_threads(2)

SCRIPT = ["p iteration", "p conflicts", "p violating", "p histogram", "p used", "p free",
          "p epsilon", "p taboo", "p colors 0 5", "p colors 3", "p nothing", "e epsilon 0.25",
          "e epsilon", "p epsilon", "h", "bogus", "x y", "", "c"]


def stepped(g, params, **kw):
    return SteppedMCMC(interop.graph_from_jax(g), params, device="cpu", **kw)


@pytest.mark.parametrize("quit_at_end", [False, True])
def test_same_script_prints_the_same_as_jax(medium_er, quit_at_end):
    jp = JParams(n_colors=medium_er.max_degree // 2, taboo_iterations=2)
    ja = JStepped(medium_er, jp)
    st = ja.step(ja.init_state(seed=3), n_steps=2)
    api = stepped(medium_er, port_params(jp), block_size=ja.block, backend="xla")
    mine = interop.stepped_from_numpy(np.asarray(st.colors), np.asarray(st.taboo),
                                      st.iteration, st.conflicts,
                                      TorchUniformSource(0, 0, "cpu").get_state())
    script = SCRIPT[:-1] + (["q"] if quit_at_end else ["c"])
    want_out, got_out = io.StringIO(), io.StringIO()
    jd = JDebugAttach(input=iter(script), output=want_out)
    jd.break_in(ja, st)
    td = DebugAttach(input=iter(script), output=got_out)
    td.break_in(api, mine)
    assert got_out.getvalue() == want_out.getvalue()
    assert (td.epsilon, td.quit) == (jd.epsilon, jd.quit) == (0.25, quit_at_end)
    assert "unknown variable 'nothing'" in got_out.getvalue()


def test_repl_prints_and_continues(small_er):
    """Mirrors tests/test_dbg.py:test_repl_prints_and_continues (a stream
    with ``readline`` this time)."""
    s = stepped(small_er, MCMCParams(n_colors=small_er.max_degree))
    st = s.step(s.init_state(seed=3), n_steps=1)
    out = io.StringIO()
    dbg = DebugAttach(input=io.StringIO("\n".join(SCRIPT) + "\n"), output=out)
    dbg.break_in(s, st)
    text = out.getvalue()
    assert str(st.iteration) in text and str(st.conflicts) in text
    assert "0.25" in text and dbg.epsilon == 0.25 and not dbg.quit
    assert "commands" in text


def test_live_epsilon_edit_reaches_the_next_segment(small_er, monkeypatch):
    """The ε edit made at a break-in is the ε of every later segment."""
    p = MCMCParams(n_colors=max(4, small_er.max_degree // 2), max_iterations=30)
    s = stepped(small_er, p)
    seen = []
    orig = s.step

    def spy(state, n_steps=1, epsilon=None):
        seen.append(epsilon)
        return orig(state, n_steps, epsilon=epsilon)

    monkeypatch.setattr(s, "step", spy)
    dbg = DebugAttach(input=iter(["e epsilon 1e-3", "c", "c"]), output=io.StringIO(),
                      break_every=True)
    r = s.run(seed=3, segment=1, dbg=dbg)
    assert seen[0] is None and len(seen) >= 2 and set(seen[1:]) == {1e-3}
    assert r.colors.shape == (small_er.n,)


def test_quit_aborts_run(small_er):
    p = MCMCParams(n_colors=max(4, small_er.max_degree // 3), max_iterations=200)
    dbg = DebugAttach(input=iter(["q"]), output=io.StringIO(), break_every=True)
    r = stepped(small_er, p).run(seed=3, segment=1, dbg=dbg)
    assert dbg.quit and r.iterations == 1


def test_esc_pending_no_tty():
    assert esc_pending(io.StringIO()) is False
    assert DebugAttach(input=iter([]), output=io.StringIO()).pending() is False


def test_cli_dbg_flag(tmp_path, monkeypatch):
    """--dbg runs the stepped chain under the debugger; without a tty it
    never breaks in and the run completes normally."""
    monkeypatch.setattr("sys.stdin", io.StringIO(""))
    rc = cli_main(["--simulate", "0.2", "-n", "80", "--mcmcgpu", "--dbg", "--seed", "3",
                   "--check", "--quiet", "--outDir", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    assert len(list(tmp_path.glob("*-MCMC_GPU-0.log"))) == 1
