"""Synchronous type-indexed event bus + trigger event types.

Host-side equivalent of ``src/core/EventBus.h`` (Subscribe/Publish/Clear over
``type_index -> handler list``).  On the device side events are dense arrays
returned by the step (:class:`banggameengine_tpu.state.StepEvents`);
:func:`dispatch_step_events` converts them into bus publishes, restoring the
reference's callback surface (``PhysicsSystem.cpp:1017-1074`` publishes
TriggerEvent{Enter,Stay,Exit}).
"""

from __future__ import annotations

import dataclasses
import enum
from collections import defaultdict
from typing import Any, Callable, Type, TypeVar

import numpy as np

T = TypeVar("T")


class TriggerPhase(enum.Enum):
    ENTER = "enter"
    STAY = "stay"
    EXIT = "exit"


@dataclasses.dataclass(frozen=True)
class TriggerEvent:
    """Mirrors the reference TriggerEvent payload: which trigger, which other
    entity, which phase."""

    trigger_entity: int
    other_entity: int
    phase: TriggerPhase
    world: int = 0  # world index for many-world batches


class EventBus:
    def __init__(self):
        self._handlers: dict[type, list[Callable[[Any], None]]] = defaultdict(list)

    def subscribe(self, event_type: Type[T], handler: Callable[[T], None]) -> Callable[[], None]:
        self._handlers[event_type].append(handler)

        def unsubscribe():
            try:
                self._handlers[event_type].remove(handler)
            except ValueError:
                pass

        return unsubscribe

    def publish(self, event: Any) -> None:
        for h in list(self._handlers[type(event)]):
            h(event)

    def clear(self) -> None:
        self._handlers.clear()


def dispatch_step_events(bus: EventBus, step_events, trig_entity,
                         stay: bool = True, world: int = 0) -> int:
    """Convert StepEvents arrays -> TriggerEvent publishes.

    Bus subscribers receive Enter/Stay/Exit every tick like the reference
    publishes them (``PhysicsSystem.cpp:1040-1058``); it is the *app*
    handler that ignores Stay (``Application.cpp:365-381``).  Pass
    ``stay=False`` to skip Stay publishes entirely (they fire every tick
    while overlapping).  Returns the number of events published.
    """
    te = np.asarray(trig_entity)
    count = 0
    phases = [
        (TriggerPhase.ENTER, np.asarray(step_events.trigger_enter)),
        (TriggerPhase.EXIT, np.asarray(step_events.trigger_exit)),
    ]
    if stay:
        phases.insert(1, (TriggerPhase.STAY, np.asarray(step_events.trigger_stay)))
    for phase, mat in phases:
        slots, others = np.nonzero(mat)
        for s, o in zip(slots.tolist(), others.tolist()):
            bus.publish(
                TriggerEvent(
                    trigger_entity=int(te[s]), other_entity=o,
                    phase=phase, world=world,
                )
            )
            count += 1
    return count
