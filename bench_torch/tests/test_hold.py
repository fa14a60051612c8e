"""Every answer is held on its own: the compared number is the worst
answer, and only an answer at which the plain float32 reference itself
departs from the float64 one by more than the cell's level is left out,
and counted."""

import pytest

from bench_torch import program


def gaps(program_gaps, f32=None, control=None):
    by = {'': list(program_gaps)}
    if f32 is not None:
        by['f32'] = list(f32)
    if control is not None:
        by['control'] = list(control)
    return {'value_gap': by}


def test_one_bad_answer_of_many_decides():
    out = program.hold(gaps([1e-7] * 15 + [1e-3]), {})
    assert out['value_gap'] == 1e-3
    assert out['value_gap.median'] == pytest.approx(1e-7)
    assert out['value_gap.excluded'] == 0


def test_only_answers_the_float32_reference_cannot_resolve_go():
    out = program.hold(
        gaps([1e-7, 2e-6, 5e-4], f32=[1e-7, 1e-7, 4e-4],
             control=[1e-5, 2e-5, 5e-4]), {'value_gap': 1e-5})
    assert out['value_gap'] == 2e-6
    assert out['value_gap.control'] == 2e-5
    assert out['value_gap.excluded'] == 1
    assert [a[''] for a in out['value_gap.each']] == [1e-7, 2e-6, 5e-4]


def test_nothing_kept_is_no_number():
    out = program.hold(gaps([1e-3], f32=[1e-2]), {'value_gap': 1e-5})
    assert out['value_gap'] is None and out['value_gap.excluded'] == 1


def test_a_level_needs_the_float32_reference():
    with pytest.raises(RuntimeError):
        program.hold(gaps([1e-7]), {'value_gap': 1e-5})
