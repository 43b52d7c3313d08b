"""Paged virtual memory for NT state (paper §4.5, C6).

Single-level page table per NT, 2 MB huge pages, on-demand physical
allocation, permission isolation, LRU swap-out to a *remote sNIC* under
over-subscription, transparent swap-in.  The paper measures 15-20 us to swap
a 2 MB page; we model 17.5 us and make it configurable.

The same class manages the ML runtime's paged KV cache: a "page" is then a
KV block and "swap" is host/neighbor-pod offload (the serving layer, still to be ported).
"""
from __future__ import annotations

from dataclasses import dataclass, field

PAGE_BYTES = 2 << 20
SWAP_NS = 17_500.0          # per 2 MB page (paper: 15-20 us)
DRAM_ACCESS_NS = 100.0
#: per-block fast-memory budget a fused kernel's resident tiles must fit: the
#: shared memory one thread block may use on an H100 (227 KB of the SM's
#: 256 KB; NVIDIA Hopper tuning guide and architecture white paper).  The
#: admission verifier's V-BUDGET-VMEM bound; the name is kept so the rule
#: reads the same in both packages.
VMEM_BUDGET_BYTES = 232_448


@dataclass
class PTE:
    frame: int = -1          # -1 => not present
    swapped: bool = False
    last_access_ns: float = 0.0


class OutOfMemory(Exception):
    pass


@dataclass
class VMStats:
    allocs: int = 0
    hits: int = 0
    swap_ins: int = 0
    swap_outs: int = 0
    faults: int = 0
    denied: int = 0


class VirtualMemory:
    """One sNIC's on-board memory manager.

    ``remote_free`` is a callable returning whether a neighbor sNIC can take
    a swapped page (distributed platform hook, §5); swap space is unbounded
    when None (single-sNIC tests).
    """

    def __init__(self, phys_bytes: int, page_bytes: int = PAGE_BYTES,
                 swap_ns: float = SWAP_NS, remote_free=None):
        self.page_bytes = page_bytes
        self.n_frames = max(1, phys_bytes // page_bytes)
        self.free_frames = list(range(self.n_frames - 1, -1, -1))
        self.tables: dict[str, dict[int, PTE]] = {}
        self.frame_owner: dict[int, tuple[str, int]] = {}
        self.swap_ns = swap_ns
        self.remote_free = remote_free
        self.swapped_pages = 0
        self.stats = VMStats()
        # DRF hook: tenant/NT -> granted page quota (None = unlimited)
        self.quota: dict[str, int] = {}

    # ------------------------------------------------------------ helpers --
    def register(self, nt_id: str) -> None:
        self.tables.setdefault(nt_id, {})

    def resident_pages(self, nt_id: str) -> int:
        return sum(1 for p in self.tables.get(nt_id, {}).values()
                   if p.frame >= 0)

    def total_pages(self, nt_id: str) -> int:
        return len(self.tables.get(nt_id, {}))

    def utilization(self) -> float:
        return 1.0 - len(self.free_frames) / self.n_frames

    # ------------------------------------------------------------- access --
    def access(self, nt_id: str, vpage: int, now_ns: float,
               write: bool = False) -> float:
        """Translate + touch a virtual page; returns added latency in ns.

        Raises OutOfMemory when neither local frames nor remote swap space
        can back a new page (paper: 'reject requests to add new NTs or to
        enlarge existing NT's memory').
        """
        if nt_id not in self.tables:
            self.stats.denied += 1
            raise PermissionError(f"NT {nt_id!r} has no address space")
        table = self.tables[nt_id]
        pte = table.get(vpage)
        if pte is None:                                    # first touch
            q = self.quota.get(nt_id)
            if q is not None and self.total_pages(nt_id) >= q:
                self.stats.denied += 1
                raise OutOfMemory(f"{nt_id} quota {q} pages")
            pte = table[vpage] = PTE()
            self.stats.allocs += 1
        if pte.frame >= 0:                                 # hit
            pte.last_access_ns = now_ns
            self.stats.hits += 1
            return DRAM_ACCESS_NS
        # fault: need a frame (fresh or swap-in)
        self.stats.faults += 1
        lat = self._claim_frame(nt_id, vpage, now_ns)
        if pte.swapped:
            pte.swapped = False
            self.swapped_pages -= 1
            self.stats.swap_ins += 1
            lat += self.swap_ns
        pte.frame = self.frame_owner_inv
        self.frame_owner[pte.frame] = (nt_id, vpage)
        pte.last_access_ns = now_ns
        return lat + DRAM_ACCESS_NS

    def _claim_frame(self, nt_id: str, vpage: int, now_ns: float) -> float:
        if self.free_frames:
            self.frame_owner_inv = self.free_frames.pop()
            return 0.0
        # over-subscribed: evict the LRU page of the most-shrinkable NT.
        victim = self._pick_victim(nt_id)
        if victim is None:
            self.stats.denied += 1
            raise OutOfMemory("no frame and no swappable victim")
        vnt, vpg = victim
        vpte = self.tables[vnt][vpg]
        if self.remote_free is not None and not self.remote_free():
            self.stats.denied += 1
            raise OutOfMemory("remote sNICs have no free memory")
        self.frame_owner_inv = vpte.frame
        del self.frame_owner[vpte.frame]
        vpte.frame = -1
        vpte.swapped = True
        self.swapped_pages += 1
        self.stats.swap_outs += 1
        return self.swap_ns                                # lazy in practice

    def _pick_victim(self, requester: str) -> tuple[str, int] | None:
        """DRF-guided: shrink the NT holding the most resident pages
        (largest share of the memory resource); LRU page inside it."""
        best_nt, best_n = None, -1
        for nt, table in self.tables.items():
            n = sum(1 for p in table.values() if p.frame >= 0)
            if n > best_n and (nt != requester or n > 1):
                best_nt, best_n = nt, n
        if best_nt is None or best_n <= 0:
            return None
        lru_pg, lru_t = None, float("inf")
        for pg, pte in self.tables[best_nt].items():
            if pte.frame >= 0 and pte.last_access_ns < lru_t:
                lru_pg, lru_t = pg, pte.last_access_ns
        return (best_nt, lru_pg) if lru_pg is not None else None

    # ---------------------------------------------------------- teardown --
    def release(self, nt_id: str) -> int:
        """Free all pages of an NT (de-launch). Returns #frames released."""
        table = self.tables.pop(nt_id, {})
        n = 0
        for pte in table.values():
            if pte.frame >= 0:
                self.free_frames.append(pte.frame)
                self.frame_owner.pop(pte.frame, None)
                n += 1
            elif pte.swapped:
                self.swapped_pages -= 1
        return n
